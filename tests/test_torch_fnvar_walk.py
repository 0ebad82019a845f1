"""Function-variable rules end to end: the port against the JAX package.

For every case of test_torch_fnvars.py (the mirrored rule texts of
tests/test_fn_lowering.py, `canonical_names.guard`, the FNVAR_RULES
workload):

  * the port's precompute → per-bucket encode → lower → torch walk (the
    StepFnVar arm) → rim, run by `ops.backend.evaluate` on the CPU with
    the plain kernel versions, gives the same statuses, unsure bits and
    rim blocks as the JAX package's `BatchEvaluator` over its own
    precompute and `encode_batch`, on every document the device decides,
    and the same set of documents left to the oracle. Raw unsure bits
    are compared with a gather-forced JAX run in a subprocess
    (GUARD_TPU_GATHER_CPU_MIN_NODES=0);
  * the port's statuses-only `validate` with its oracle reruns prints the
    same stdout and stderr and exits with the same code as the JAX
    package's `validate --backend tpu --statuses-only`, and reruns
    exactly the documents the JAX package's rim masks send to its
    oracle (`Evaluation.oracle_docs`).

The port's oracle is the CPU evaluator. The JAX package puts its
optional native C++ statuses engine (native/oracle.cpp, built on
demand) in front of it where that engine accepts the rules; a failing
document it settles then reports its failing rules without clause
detail, where the CPU evaluator's rerun reports them in full. So the
JAX side runs with the native engine switched off (`python_oracle`).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from guard_tpu_torch.commands.validate import RuleFile, Validate
from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.core.values import from_plain as t_from_plain
from guard_tpu_torch.ops import kernels as walk
from guard_tpu_torch.ops.backend import evaluate
from guard_tpu_torch.utils.io import Reader, Writer
from test_torch_cli import python_oracle, run_jax_err  # noqa: F401 (a fixture)
from test_torch_fnvars import CASES, IDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GATHER_FN_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from guard_tpu.core.parser import parse_rules_file
from guard_tpu.core.values import from_plain
from guard_tpu.ops.encoder import NODE_BUCKETS_EXTENDED, encode_batch
from guard_tpu.ops.fnvars import precompute_fn_values
from guard_tpu.ops.ir import build_rim_spec, compile_rules_file
from guard_tpu.ops import kernels
assert kernels.GATHER_CPU_MIN_NODES == 0
out = []
for text, docs in json.load(sys.stdin):
    rf = parse_rules_file(text, "fn.guard")
    pvs = [from_plain(d) for d in docs]
    keys, vals, err = precompute_fn_values(rf, pvs)
    batch, interner = encode_batch(pvs, fn_values=vals, fn_var_order=keys)
    if err:
        batch.num_exotic[sorted(err)] = True
    compiled = compile_rules_file(rf, interner)
    n_real = (batch.node_kind >= 0).sum(axis=1)
    host = (n_real > NODE_BUCKETS_EXTENDED[-1]) | batch.num_exotic
    res = {"host": np.where(host)[0].tolist(),
           "host_rules": [r.rule_name for r in compiled.host_rules],
           "statuses": None}
    if compiled.rules:
        be = kernels.BatchEvaluator(compiled)
        st = be(batch)
        un = be.last_unsure
        if un is None:
            un = np.zeros(st.shape, bool)
        spec = build_rim_spec([compiled.rules])
        rim = kernels.rim_reduce(st, un, spec.group_ids, spec.file_ids,
                                 spec.last_ids, spec.n_groups, spec.n_files)
        res.update(statuses=st.tolist(), unsure=un.tolist(),
                   rim=[np.asarray(r).tolist() for r in rim])
    out.append(res)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def gather_reference():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "GUARD_TPU_GATHER_ON_CPU": "1",
        "GUARD_TPU_GATHER_CPU_MIN_NODES": "0",
        "PYTHONPATH": ROOT,
    })
    proc = subprocess.run(
        [sys.executable, "-c", _GATHER_FN_SCRIPT],
        input=json.dumps([[t, d] for _n, t, d in CASES]),
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(zip(IDS, json.loads(proc.stdout)))


def port_file_result(text, docs):
    rf = RuleFile("fn.guard", "fn.guard", text, t_parse(text, "fn.guard"))
    return evaluate([rf], [t_from_plain(d) for d in docs], "cpu").files[0]


@pytest.mark.parametrize("name,text,docs", CASES, ids=IDS)
def test_walk_matches_gather_forced_reference(gather_reference, name, text, docs):
    ref = gather_reference[name]
    fr = port_file_result(text, docs)
    assert sorted(fr.host_docs) == ref["host"]
    assert [r.rule_name for r in fr.compiled.host_rules] == ref["host_rules"]
    if ref["statuses"] is None:
        assert not fr.compiled.rules
        return
    dev = np.ones(len(docs), bool)
    dev[ref["host"]] = False
    np.testing.assert_array_equal(fr.statuses[dev], np.array(ref["statuses"], np.int8)[dev])
    if fr.compiled.needs_unsure:
        np.testing.assert_array_equal(fr.unsure[dev], np.array(ref["unsure"], bool)[dev])
    else:
        assert not np.array(ref["unsure"], bool)[dev].any()
    for k, (mine, theirs) in enumerate(zip(fr.rim, ref["rim"])):
        if k in (1, 4) and not fr.compiled.needs_unsure:
            continue  # the port's rim carries no unsure blocks then
        np.testing.assert_array_equal(mine[dev], np.array(theirs, mine.dtype)[dev])


def test_step_fn_var_runs_per_origin_in_the_walk():
    """canonical_names.guard reads two per-origin slots and a per-origin
    variable; the walk's StepFnVar arm gates them through one gather
    each (on the CPU the plain version, so no kernel launch)."""
    name, text, docs = next(c for c in CASES if c[0] == "canonical_names")
    before = dict(walk.FNVAR_STEPS)
    fr = port_file_result(text, docs)
    assert fr.compiled.needs_fn_origin and not fr.compiled.host_rules
    assert walk.FNVAR_STEPS["per_origin"] > before["per_origin"]
    assert walk.FNVAR_STEPS["k1_launches"] == before["k1_launches"]


def _write_docs(tmp_path, docs):
    data = tmp_path / "data"
    data.mkdir()
    for i, doc in enumerate(docs):
        (data / f"d{i:02d}.json").write_text(json.dumps(doc))
    return data


# an error message may carry the repr of a map value: its module and
# address differ between any two processes, the reference's too
_OBJECT_REPR = re.compile(r"<guard_tpu(?:_torch)?\.core\.values\.MapValue object at 0x[0-9a-f]+>")


def _stable(err: str) -> str:
    return _OBJECT_REPR.sub("<MapValue>", err)


def run_both(rules_path, data, show="all"):
    args = ["-r", str(rules_path), "-d", str(data), "--show-summary", show]
    rc_j, out_j, err_j = run_jax_err(args)
    cmd = Validate(rules=[str(rules_path)], data=[str(data)], show_summary=show.split(","),
                   statuses_only=True, device="cpu", result_cache=False)
    tw = Writer.buffered()
    rc_p = cmd.execute(tw, Reader.from_string(""))
    return ((rc_j, out_j, _stable(err_j)),
            (rc_p, tw.stripped(), _stable(tw.err_to_stripped())), cmd)


def expected_oracle_docs(ref, n_docs) -> int:
    """The JAX package's rim masks under --statuses-only: host documents,
    documents with an unsure bit, every document when there are host
    rules."""
    if ref["host_rules"]:
        return n_docs
    need = np.zeros(n_docs, bool)
    need[ref["host"]] = True
    if ref["statuses"] is not None:
        need |= np.array(ref["unsure"], bool).any(axis=1)
    return int(need.sum())


@pytest.mark.parametrize("name,text,docs", CASES, ids=IDS)
def test_validate_with_oracle_reruns_matches_jax(gather_reference, python_oracle, tmp_path,
                                                 name, text, docs):
    (tmp_path / "fn.guard").write_text(text)
    data = _write_docs(tmp_path, docs)
    want, got, cmd = run_both(tmp_path / "fn.guard", data)
    assert got == want
    ev = cmd.last_evaluation
    assert ev.oracle_docs == expected_oracle_docs(gather_reference[name], len(docs))
