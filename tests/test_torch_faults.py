"""The port's fault points and degradation ladder against the JAX
package's.

* `oracle`: the inline CPU rerun of a document fires
  `maybe_fail("oracle", key=<document name>)`, as the JAX package's
  does (guard_tpu/ops/backend.py:1592). Under `GUARD_TPU_FAULT=
  oracle:nth=1` and `oracle:glob=t01.json` both CLIs print the same
  stdout and stderr and exit with the same code, with the native oracle
  not built in either package and built in both.
* `dispatch` and `collect`: an injected dispatch or collect fault
  degrades — a pack's bucket reruns per file on the device, a file's
  bucket goes to the host oracle — and the run prints what the unarmed
  run prints (and what the JAX package prints), with
  `dispatch_fallbacks` counted. A packed collect past
  `GUARD_TPU_DISPATCH_TIMEOUT` reruns per file on the device; a
  per-file one ends the run with rc 5. Any other error (what a kernel
  that does not build or launch raises) ends the run: the ladder never
  carries a real device failure to the CPU.
"""

import json

import numpy as np
import pytest

import bench
from guard_tpu.utils import faults as jax_faults
from guard_tpu_torch.parallel import device as port_device
from guard_tpu_torch.utils import faults as port_faults
from test_torch_reports import native_lib_dir, run_jax, run_port, set_native  # noqa: F401

RULES_B = (
    "rule named { Resources.*.Properties.BucketName in ['logs', 'data'] }\n"
    "rule typed { Resources.*.Type == /^AWS::/ }\n"
)


PLAN_DIRS = {}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """No armed fault, fresh fault state in both packages, the JAX side
    computed (no result cache, serial ingest), each package's plan
    artifacts in a directory of its own."""
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)
    monkeypatch.delenv("GUARD_TPU_DISPATCH_TIMEOUT", raising=False)
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    PLAN_DIRS.update(jax=str(tmp_path / "jax_plans"), port=str(tmp_path / "port_plans"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", PLAN_DIRS["port"])
    jax_faults.reset_faults()
    port_faults.reset_faults()
    yield
    jax_faults.reset_faults()
    port_faults.reset_faults()


@pytest.fixture(params=["native_off", "native_built"])
def native_state(request, monkeypatch):
    lib_dir = None
    if request.param == "native_built":
        lib_dir = request.getfixturevalue("native_lib_dir")
    set_native(monkeypatch, lib_dir)
    return request.param


def write_templates(root, n=6, seed=9, extra_rules=()):
    """bench.RULES (and `extra_rules`) over `n` seeded make_template
    templates t00.json ..."""
    (root / "rules").mkdir()
    (root / "rules" / "a_security.guard").write_text(bench.RULES)
    for i, text in enumerate(extra_rules):
        (root / "rules" / f"b_extra{i}.guard").write_text(text)
    (root / "data").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        (root / "data" / f"t{i:02d}.json").write_text(json.dumps(bench.make_template(rng, i)))
    return ["-r", str(root / "rules"), "-d", str(root / "data")]


def both(args):
    """(JAX, port) (rc, stdout, stderr), each package's fault state fresh
    (an nth= spec fires once per process) and its own plan directory,
    and the port's Evaluation."""
    import os

    jax_faults.reset_faults()
    os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = PLAN_DIRS["jax"]
    try:
        want = run_jax(args)
    finally:
        os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = PLAN_DIRS["port"]
    port_faults.reset_faults()
    got, ev = run_port(args)
    return want, got, ev


# -- the oracle fault point --------------------------------------------
@pytest.mark.parametrize("spec", ["oracle:nth=1", "oracle:glob=t01.json"])
def test_oracle_fault_matches_jax(native_state, monkeypatch, tmp_path, spec):
    args = write_templates(tmp_path)
    monkeypatch.setenv("GUARD_TPU_FAULT", spec)
    want, got, _ev = both(args)
    assert got == want
    if native_state == "native_off":
        # the CPU evaluator reruns the failing documents: the fault fires
        name = "t00.json" if spec.endswith("nth=1") else "t01.json"
        assert got[0] == 5
        assert f"injected oracle fault ({name})" in got[2]
        assert port_faults.FAULT_COUNTERS["injected_oracle"] == 1
        assert f"{name} Status" not in got[1]
    else:
        # the native oracle builds every report: the CPU rerun never runs
        assert got[0] == 19 and got[2] == ""


def test_oracle_fault_is_a_hard_error(monkeypatch, tmp_path):
    """The host oracle is the ladder's last rung: a failure there is an
    evaluation error (rc 5) whatever the device did."""
    args = write_templates(tmp_path, extra_rules=(RULES_B,))
    set_native(monkeypatch, None)
    monkeypatch.setenv("GUARD_TPU_FAULT", "oracle:nth=1")
    (rc, _out, err), ev = run_port(args)
    assert rc == 5 and err.startswith("injected oracle fault")
    assert ev.packs, "the two rules files did not pack"
    stats = port_faults.fault_stats()
    assert stats["injected_oracle"] == 1
    assert stats["dispatch_fallbacks"] == stats["oracle_fallbacks"] == 0


# -- the dispatch/collect ladder ---------------------------------------
@pytest.mark.parametrize("pack", [[], ["--no-pack"]], ids=["packed", "perfile"])
@pytest.mark.parametrize("point", ["dispatch", "collect"])
def test_device_fault_keeps_the_output(monkeypatch, tmp_path, point, pack):
    """A failed dispatch or collect of one bucket costs a rung of the
    ladder, never an answer: stdout, stderr and rc equal the unarmed
    run's and the JAX package's."""
    args = write_templates(tmp_path, extra_rules=(RULES_B,)) + pack
    set_native(monkeypatch, None)
    base, ev = run_port(args)
    assert base[0] == 19
    assert bool(ev.packs) == (not pack)
    assert port_faults.FAULT_COUNTERS["dispatch_fallbacks"] == 0
    assert port_faults.FAULT_COUNTERS["oracle_fallbacks"] == 0
    monkeypatch.setenv("GUARD_TPU_FAULT", f"{point}:nth=1")
    want, got, ev = both(args)
    assert got == base == want
    stats = port_faults.fault_stats()
    assert stats[f"injected_{point}"] == 1
    assert stats["dispatch_fallbacks"] >= 1
    if pack:
        # per file, the bucket went to the host oracle
        assert stats["oracle_fallbacks"] >= 1
        assert any(fr.host_docs for fr in ev.files)
    else:
        # the pack's bucket reran per file and kept its device answer
        assert stats["oracle_fallbacks"] == 0
        assert not any(fr.host_docs for fr in ev.files)


def test_packed_fault_rim_equals_unarmed(monkeypatch, tmp_path):
    """The rim blocks a failed packed collect lost are recomputed from
    the per-file statuses: every block equals the unarmed run's."""
    args = write_templates(tmp_path, n=10, extra_rules=(RULES_B,))
    set_native(monkeypatch, None)
    _base, base_ev = run_port(args + ["--statuses-only"])
    monkeypatch.setenv("GUARD_TPU_FAULT", "collect:nth=1")
    port_faults.reset_faults()
    _got, ev = run_port(args + ["--statuses-only"])
    assert port_faults.FAULT_COUNTERS["dispatch_fallbacks"] == 1
    for fr, br in zip(ev.files, base_ev.files):
        assert fr.pack == br.pack == 0
        np.testing.assert_array_equal(fr.statuses, br.statuses)
        np.testing.assert_array_equal(fr.unsure, br.unsure)
        for a, b in zip(fr.rim, br.rim):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pack", [[], ["--no-pack"]], ids=["packed", "perfile"])
def test_dispatch_timeout_takes_the_ladder(monkeypatch, tmp_path, pack):
    """A collect past GUARD_TPU_DISPATCH_TIMEOUT is a GuardError. A
    packed bucket reruns per file on the device and the output stays
    the unarmed run's; on the per-file path the timeout ends the run
    with rc 5 and no document goes to the host oracle."""
    import threading

    args = write_templates(tmp_path, extra_rules=(RULES_B,)) + pack
    set_native(monkeypatch, None)
    base, _ev = run_port(args)
    real = port_device.DeviceBatchEvaluator.collect
    release = threading.Event()
    calls = []

    def stuck_once(self, handle):
        calls.append(1)
        if len(calls) == 1:
            release.wait(10)  # the first collect hangs past the timeout
        return real(self, handle)

    monkeypatch.setattr(port_device.DeviceBatchEvaluator, "collect", stuck_once)
    monkeypatch.setenv("GUARD_TPU_DISPATCH_TIMEOUT", "0.2")
    port_faults.reset_faults()
    try:
        got, _ev = run_port(args)
    finally:
        release.set()
    stats = port_faults.fault_stats()
    assert stats["oracle_fallbacks"] == 0
    if pack:
        assert got[0] == 5 and got[1] == ""
        assert "device call timed out after 0.2s" in got[2]
        assert stats["dispatch_fallbacks"] == 0
    else:
        assert got == base
        assert stats["dispatch_fallbacks"] >= 1


@pytest.mark.parametrize("stage", ["dispatch", "collect"])
@pytest.mark.parametrize("pack", [[], ["--no-pack"]], ids=["packed", "perfile"])
def test_device_error_is_not_degraded(monkeypatch, tmp_path, stage, pack):
    """An error that is not a GuardError — what a kernel that does not
    build or launch raises — ends the run with rc 5; no rung of the
    ladder takes it to the CPU."""
    args = write_templates(tmp_path, extra_rules=(RULES_B,)) + pack
    set_native(monkeypatch, None)

    def broken(self, *a):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_device.DeviceBatchEvaluator, stage, broken)
    (rc, out, err), ev = run_port(args)
    assert rc == 5 and out == "" and ev is None
    assert err.startswith("Error: CUDA error")
    stats = port_faults.fault_stats()
    assert stats["dispatch_fallbacks"] == stats["oracle_fallbacks"] == 0


def test_timeout_setting(monkeypatch):
    monkeypatch.setenv("GUARD_TPU_DISPATCH_TIMEOUT", "2.5")
    assert port_faults.dispatch_timeout() == 2.5 == jax_faults.dispatch_timeout()
    monkeypatch.setenv("GUARD_TPU_DISPATCH_TIMEOUT", "soon")
    assert port_faults.dispatch_timeout() == 0.0 == jax_faults.dispatch_timeout()
    monkeypatch.delenv("GUARD_TPU_DISPATCH_TIMEOUT")
    assert port_faults.bounded_call(lambda x: x + 1, 1) == 2


def test_fault_counters_carry_the_jax_names():
    from guard_tpu.utils.faults import FAULT_COUNTERS as JAX_COUNTERS

    assert set(port_faults.FAULT_COUNTERS) <= set(JAX_COUNTERS)
    for key in ("dispatch_fallbacks", "oracle_fallbacks", "quarantined_docs",
                "injected_oracle", "injected_dispatch", "injected_collect"):
        assert key in port_faults.FAULT_COUNTERS


def test_per_file_rerun_timeout_ends_the_run(monkeypatch, tmp_path):
    """A packed bucket whose collect and then per-file rerun both time
    out ends the run with rc 5: the ladder never sends it to the host
    oracle."""
    import threading

    args = write_templates(tmp_path, extra_rules=(RULES_B,))
    set_native(monkeypatch, None)
    real = port_device.DeviceBatchEvaluator.collect
    release = threading.Event()

    def stuck(self, handle):
        release.wait(10)
        return real(self, handle)

    monkeypatch.setattr(port_device.DeviceBatchEvaluator, "collect", stuck)
    monkeypatch.setenv("GUARD_TPU_DISPATCH_TIMEOUT", "0.2")
    try:
        (rc, out, err), ev = run_port(args)
    finally:
        release.set()
    assert rc == 5 and out == "" and ev is None
    assert "device call timed out after 0.2s" in err
    stats = port_faults.fault_stats()
    assert stats["dispatch_fallbacks"] == 1 and stats["oracle_fallbacks"] == 0
