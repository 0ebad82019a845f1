"""Multi-process runs of the port (guard_tpu_torch/parallel/distributed.py)
against the JAX package on one process, on the CPU.

The counterpart of tests/test_multihost_distributed.py: rank processes,
each with a local mesh of `[cpu] * 4` (the JAX test's 4 virtual CPU
devices a process), join one gloo group over an ephemeral port on
127.0.0.1. Each rank encodes only its own contiguous document range
(`process_bounds`), runs `DistributedEvaluator.with_summary` and writes
its range, statuses and all-reduced counts to a JSON file. The rank
code imports guard_tpu_torch and never guard_tpu or jax, and asserts
it. This process computes the reference with the JAX package on one
process: `ShardedBatchEvaluator.with_summary` on its 8-device CPU mesh,
whose counts are `_shared_evaluator_fns.summarize`'s. Each rank's
statuses equal the JAX rows of its range and its counts the JAX counts,
exactly. Cases:

  * the JAX test's RULES and 16 documents over 2 ranks, one DocBatch a
    rank, as there;
  * the cross-reference policy (workloads.XREF_RULES: query-RHS
    compares and `.%var` interpolation, the plain versions of K4-K6)
    over 37 documents, bucketed (the counts summed over the buckets
    before the all-reduce);
  * 1 document over 2 ranks (rank 1's range is empty: it joins with
    zeros);
  * 3 ranks over 16 documents;
  * a rank that never starts (either one): the other raises within
    its short `timeout_s` and exits non-zero; a rank that dies after
    joining: the survivor's collective raises;
  * ranks whose rules differ in R, or in program with the same R: every
    rank raises before any count crosses.

Raw unsure bits are not compared (the JAX CPU reference decides some
set compares on its one-hot arm, ROADMAP "Traps"); the JAX test's rules
have none. No tolerance anywhere.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from guard_tpu_torch.parallel import distributed
from guard_tpu_torch.workloads import XREF_RULES, make_xref_template
from test_torch_summary import jax_summary

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the JAX test's rules and corpus (tests/test_multihost_distributed.py)
RULES = """
rule enc { Resources.*[ Type == 'B' ] { Properties.E exists } }
rule named when enc { Resources.*.Name exists }
"""
# R 3 against RULES' 2; and RULES' R with another program
RULES_MORE = RULES + "rule typed { Resources.*.Type exists }\n"
RULES_OTHER = """
rule enc { Resources.*[ Type == 'B' ] { Properties.E empty } }
rule named when enc { Resources.*.Name exists }
"""


def jax_docs(n=16):
    return [
        {"Resources": {f"r{i}": {
            "Type": "B",
            "Properties": ({"E": 1} if i % 3 else {}),
            **({"Name": f"n{i}"} if i % 2 else {}),
        }}}
        for i in range(n)
    ]


def xref_docs(n):
    rng = np.random.default_rng(77)
    return [make_xref_template(rng, i) for i in range(n)]


_RANK = textwrap.dedent(
    '''
    import json, os, sys
    sys.path.insert(0, os.getcwd())  # the repo root (the test sets cwd)
    spec = json.load(open(sys.argv[1]))
    rank, port = int(sys.argv[2]), sys.argv[3]
    if spec.get("die_after_join") == rank:
        from guard_tpu_torch.parallel import distributed
        distributed.initialize(f"127.0.0.1:{port}", spec["world"], rank,
                               timeout_s=spec["timeout_s"])
        os._exit(3)

    import torch
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_batch, encode_bucketed
    from guard_tpu_torch.ops.ir import compile_rules_file
    from guard_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", spec["world"], rank,
                           timeout_s=spec["timeout_s"])
    assert distributed.process_index() == rank
    assert distributed.process_count() == spec["world"]
    lo, hi = distributed.process_bounds(len(spec["docs"]))
    docs = [from_plain(d) for d in spec["docs"][lo:hi]]
    rules = parse_rules_file(spec["rules"][rank], "m.guard")
    if spec["bucketed"]:
        local, oversize, interner = encode_bucketed(docs)
        assert len(oversize) == 0
    else:
        local, interner = encode_batch(docs)
    compiled = compile_rules_file(rules, interner)
    assert not compiled.host_rules
    ev = distributed.DistributedEvaluator(compiled, [torch.device("cpu")] * spec["local"])
    statuses, start, counts = ev.with_summary(local)
    distributed.shutdown()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "guard_tpu"))
    assert not leaked, leaked
    assert "jax" not in sys.modules
    with open(spec["out"] % rank, "w") as f:
        json.dump({"lo": lo, "hi": hi, "start": start, "statuses": statuses.tolist(),
                   "counts": counts.tolist(), "dtypes": [str(statuses.dtype),
                                                         str(counts.dtype)]}, f)
    print(f"OK rank={rank}", flush=True)
    '''
)


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_ranks(tmp_path, rules, docs, world, ranks=None, local=4, bucketed=False,
              timeout_s=120.0, die_after_join=None, wait_s=300):
    """Start `ranks` (default every rank of `world`) as processes; return
    [(rc, output, elapsed, result or None)] per started rank."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "rules": rules if isinstance(rules, list) else [rules] * world,
        "docs": docs, "world": world, "local": local, "bucketed": bucketed,
        "timeout_s": timeout_s, "die_after_join": die_after_join,
        "out": str(tmp_path / "rank%d.json"),
    }))
    port = free_port()
    t0 = time.monotonic()
    procs = [
        subprocess.Popen([sys.executable, str(script), str(spec), str(r), port],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         cwd=str(ROOT))
        for r in (range(world) if ranks is None else ranks)
    ]
    got = []
    try:
        for r, p in zip(range(world) if ranks is None else ranks, procs):
            out, _ = p.communicate(timeout=wait_s)
            res = tmp_path / f"rank{r}.json"
            got.append((p.returncode, out, time.monotonic() - t0,
                        json.loads(res.read_text()) if res.exists() else None))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return got


def assert_ranks_match_jax(got, rules, docs, world):
    want_statuses, want_counts = jax_summary(rules, docs)
    assert want_statuses.shape == (len(docs), want_counts.shape[1])
    covered = 0
    for r, (rc, out, _t, res) in enumerate(got):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"OK rank={r}" in out
        lo, hi = res["lo"], res["hi"]
        assert res["start"] == lo == covered
        assert res["dtypes"] == ["int8", "int32"]
        statuses = np.asarray(res["statuses"], np.int8).reshape(hi - lo, want_counts.shape[1])
        np.testing.assert_array_equal(statuses, want_statuses[lo:hi])
        np.testing.assert_array_equal(np.asarray(res["counts"]), want_counts)
        covered = hi
    assert covered == len(docs) and len(got) == world
    assert int(want_counts.sum()) == len(docs) * want_counts.shape[1]


CASES = {
    # name: (rules, docs, world, bucketed)
    "jax_rules_16_two_ranks": (RULES, jax_docs(16), 2, False),
    "xref_37_two_ranks_bucketed": (XREF_RULES, xref_docs(37), 2, True),
    "one_document_empty_rank": (RULES, jax_docs(1), 2, False),
    "jax_rules_16_three_ranks": (RULES, jax_docs(16), 3, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_jax_on_one_process(tmp_path, case):
    rules, docs, world, bucketed = CASES[case]
    got = run_ranks(tmp_path, rules, docs, world, bucketed=bucketed)
    assert_ranks_match_jax(got, rules, docs, world)


def test_the_cases_cut_their_documents_as_intended():
    assert distributed.slice_bounds(1, 2) == [(0, 1), (1, 1)]
    assert distributed.slice_bounds(16, 3) == [(0, 6), (6, 11), (11, 16)]
    assert distributed.slice_bounds(37, 2) == [(0, 19), (19, 37)]


@pytest.mark.parametrize("missing", [0, 1])
def test_a_rank_that_never_starts_raises_within_its_timeout(tmp_path, missing):
    """Rank 0 hosts the rendezvous: without rank 1 it waits out its
    timeout; without rank 0, rank 1 cannot reach it. Either raises and
    exits non-zero, well before the test's own limit."""
    (rc, out, elapsed, res), = run_ranks(tmp_path, RULES, jax_docs(4), 2,
                                         ranks=[1 - missing], timeout_s=5.0, wait_s=120)
    assert rc != 0 and res is None, out[-2000:]
    assert "Traceback" in out
    assert elapsed < 90, f"{elapsed:.1f}s to give up"


def test_a_rank_that_dies_after_joining_makes_the_other_raise(tmp_path):
    got = run_ranks(tmp_path, RULES, jax_docs(4), 2, timeout_s=10.0, die_after_join=1,
                    wait_s=120)
    (rc0, out0, elapsed, res0), (rc1, _out1, _t1, res1) = got
    assert rc1 == 3 and res1 is None
    assert rc0 != 0 and res0 is None, out0[-2000:]
    assert elapsed < 90, f"{elapsed:.1f}s to give up"


@pytest.mark.parametrize("other", ["rule_count", "program"])
def test_ranks_whose_rules_differ_raise_on_every_rank(tmp_path, other):
    second = RULES_MORE if other == "rule_count" else RULES_OTHER
    got = run_ranks(tmp_path, [RULES, second], jax_docs(16), 2, timeout_s=60.0)
    for r, (rc, out, elapsed, res) in enumerate(got):
        assert rc != 0 and res is None, f"rank {r}:\n{out[-2000:]}"
        assert "the ranks' rules differ" in out, out[-2000:]
        assert elapsed < 60


def test_outside_a_group_a_process_is_rank_0_of_1():
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.process_bounds(7) == (0, 7)


def test_local_devices():
    assert distributed.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.local_devices()
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.local_devices("cuda:0")


def test_initialize_refuses_a_rank_outside_the_world():
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1", 2, 2)
