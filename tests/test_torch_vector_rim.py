"""The scalar rim of the port (`--no-vector-rim`: no K3 launch, pass A
walking every (document, rule) status) against the JAX package's
`--no-vector-rim` and against the port's vector rim, on the CPU.

Stdout, stderr and rc are the same bytes (no tolerance), and the `rim`
counter group gives the same counts as the JAX package's: every
non-quarantined (document, rules file) pair materialized and none
settled under the scalar rim, the failures alone on the vector rim.
"""

from unittest import mock

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.ops import backend as jax_backend
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch import kernels as K
from guard_tpu_torch.ops import backend as port_backend
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.utils.io import Writer
from test_torch_reports import _Recording, set_native, write_fixture

FLAG_SETS = {
    "statuses_only": ["--statuses-only"],
    "single_line": [],
    "single_line_all": ["-S", "all"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
    "junit": ["-z", "-o", "junit", "-S", "none"],
    "per_file": ["--no-pack", "-S", "all"],
    "quarantine": ["--max-doc-failures", "3", "-S", "fail,pass"],
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    # an rc-5 run dumps here if the flight recorder is armed
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    set_native(monkeypatch, None)
    port_plan.clear_plan_memo()
    yield
    port_plan.clear_plan_memo()


@pytest.fixture
def root(tmp_path):
    root = write_fixture(tmp_path)
    # a document that does not load, quarantined under --max-doc-failures
    (root / "bad").mkdir()
    (root / "bad" / "broken.json").write_text('{"Resources": ')
    return root


def args_for(root, flags):
    data = [str(root / "data")]
    if flags == "quarantine":
        data.append(str(root / "bad"))
    return ["-r", str(root / "rules"), "-d", *data, *FLAG_SETS[flags]]


def run_jax(args):
    jax_backend.reset_rim_stats()
    w = JaxWriter.buffered()
    rc = jax_cli.run(["validate", "--backend", "tpu", *args], writer=w)
    return (rc, w.stripped(), w.err_to_stripped()), jax_backend.rim_stats()


def run_port(args):
    """(rc, stdout, stderr), the rim counters, the K3 launches and the
    Evaluation."""
    calls = []
    real = K.rim_reduce

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    for k in port_backend.RIM_COUNTERS:
        port_backend.RIM_COUNTERS[k] = 0
    w = Writer.buffered()
    _Recording.last = None
    with mock.patch.object(port_cli, "Validate", _Recording), \
            mock.patch.object(K, "rim_reduce", counting):
        rc = port_cli.run(["validate", "--device", "cpu", "--no-result-cache", *args],
                          writer=w)
    ev = _Recording.last.last_evaluation
    return (rc, w.stripped(), w.err_to_stripped()), dict(port_backend.RIM_COUNTERS), calls, ev


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_scalar_rim_matches_jax_and_the_vector_rim(root, flags):
    args = args_for(root, flags)
    vector_want, vector_rim = run_jax(args)
    scalar_want, scalar_rim = run_jax([*args, "--no-vector-rim"])
    vector, v_counts, v_calls, _ = run_port(args)
    scalar, s_counts, s_calls, ev = run_port([*args, "--no-vector-rim"])
    assert vector == vector_want
    assert scalar == scalar_want
    assert (scalar[0], scalar[1]) == (vector[0], vector[1])
    assert s_counts == scalar_rim and v_counts == vector_rim
    # the scalar rim launches no K3 and leaves no rim block
    assert s_calls == [] and v_calls
    assert all(fr.rim is None for fr in ev.files)
    assert s_counts["docs_settled"] == 0
    # every pair a document that loaded makes with a rules file
    n_pairs = (ev.n_docs - len(_quarantined(scalar[2]))) * len(ev.files)
    assert s_counts["docs_materialized"] == n_pairs


def _quarantined(err: str):
    return [l for l in err.splitlines() if l.startswith("skipping ")]


def test_scalar_rim_statuses_equal_the_vector_rims(root):
    """The scalar run's statuses and unsure bits are the vector run's:
    only the rim differs."""
    args = [*args_for(root, "quarantine"), "--statuses-only"]
    _v, _vc, _vcalls, vev = run_port(args)
    _s, _sc, _scalls, sev = run_port([*args, "--no-vector-rim"])
    for vf, sf in zip(vev.files, sev.files):
        assert (vf.statuses == sf.statuses).all() and (vf.unsure == sf.unsure).all()
        assert vf.host_docs == sf.host_docs
