"""The port's entry points (guard_tpu_torch/entry.py) against the
JAX package's (`__graft_entry__.py`), on the CPU.

  * `entry(device="cpu")`'s forward gives the same (8, R) statuses as
    `__graft_entry__.entry()`'s;
  * `dryrun(device="cpu")` passes its own checks, and its counts equal
    the JAX package's `ShardedBatchEvaluator.with_summary` on the same
    batch (the flagship plus the host-fallback `now()` rule over 2
    example documents in two node buckets);
  * without a card and without an explicit device both entry points
    raise;
  * `python -m guard_tpu_torch.entry --device cpu` exits 0, prints its
    `dryrun OK` line and imports neither JAX nor the JAX package.

Every value is an integer: exact equality, no tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.ops.encoder import encode_batch as j_encode
from guard_tpu.ops.ir import compile_rules_file as j_compile
from guard_tpu.parallel.mesh import ShardedBatchEvaluator, default_mesh
from guard_tpu_torch import entry as port_entry
from guard_tpu_torch.workloads import FLAGSHIP_RULES, HOST_ORACLE_RULES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys
from guard_tpu_torch.entry import main
rc = main(["--device", "cpu"])
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "guard_tpu")
                or m.startswith(("jax.", "jaxlib.", "guard_tpu.")))
print("leaked", leaked)
sys.exit(rc or (1 if leaked else 0))
"""


def test_workloads_copy_the_flagship_rules():
    assert FLAGSHIP_RULES == graft._RULES
    assert HOST_ORACLE_RULES == graft._DRYRUN_RULES


def test_entry_forward_matches_jax():
    fn, args = graft.entry()
    want = np.asarray(fn(*args))
    forward, (arrays, lits) = port_entry.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in arrays.values())
    statuses, unsure = forward(arrays, lits)
    assert statuses.dtype == torch.int8 and tuple(statuses.shape) == want.shape
    assert want.shape[0] == 8
    np.testing.assert_array_equal(statuses.numpy(), want)
    assert not unsure.any()


def test_dryrun_counts_match_jax(capsys):
    statuses, counts = port_entry.dryrun(device="cpu")
    assert "dryrun OK" in capsys.readouterr().out
    rules = j_parse(graft._DRYRUN_RULES, "flagship.guard")
    batch, interner = j_encode(graft._example_docs(2, two_buckets=True))
    compiled = j_compile(rules, interner)
    want_statuses, want_counts = ShardedBatchEvaluator(
        compiled, default_mesh()).with_summary(batch)
    np.testing.assert_array_equal(statuses, want_statuses)
    np.testing.assert_array_equal(counts, want_counts)
    assert int(counts.sum()) == 2 * len(compiled.rules)


@pytest.mark.parametrize("call", ["entry", "dryrun"])
def test_without_a_card_the_entry_points_raise(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port_entry, call)()


def test_module_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "guard_tpu_torch.entry", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("entry OK:")
    assert lines[1].startswith("dryrun OK: 1 cpu device, batch 2 over 2 buckets")


def test_module_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun OK" in proc.stdout and "leaked []" in proc.stdout
