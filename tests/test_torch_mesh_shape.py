"""`--mesh-shape` in the port (guard_tpu_torch/parallel/mesh2d.py,
resolved by ops/backend.dispatch_packs) against the JAX package's
(guard_tpu/parallel/mesh2d.py), on the CPU.

The port resolves the shape as the JAX package does and then runs
unsharded on one device for every shape: one K3 launch per (pack,
bucket), as without the flag. The JAX package runs on its 8-device CPU
mesh, where `Rx1` and `RxC` shapes do shard (GUARD_TPU_MESH_MIN_DOCS=4
lets its 15-document fixture split). Either way stdout, stderr and rc
are the same bytes (no tolerance), a malformed value raises the same
ValueError and a shape wider than the devices logs the same warning.
"""

from unittest import mock

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.parallel import mesh2d as jax_mesh2d
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch import kernels as K
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.parallel import mesh2d
from guard_tpu_torch.utils import telemetry
from guard_tpu_torch.utils.io import Writer
from test_torch_reports import _Recording, set_native, write_fixture

SHAPES = ["off", "auto", "1x1", "2x1", "4x1", "1x2", "3x2", "16x1"]
FLAG_SETS = {
    "statuses_only": ["--statuses-only"],
    "single_line_all": ["-S", "all"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    # an rc-5 run dumps here if the flight recorder is armed
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_MESH_MIN_DOCS", "4")
    # the JAX CLI seeds GUARD_TPU_MESH from --mesh-shape and leaves it
    # set: restored after each test
    monkeypatch.setenv("GUARD_TPU_MESH", "off")
    set_native(monkeypatch, None)
    port_plan.clear_plan_memo()
    yield
    port_plan.clear_plan_memo()


@pytest.fixture
def fixture_args(tmp_path):
    root = write_fixture(tmp_path)
    return ["-r", str(root / "rules"), "-d", str(root / "data")]


def run_jax(args):
    w = JaxWriter.buffered()
    rc = jax_cli.run(["validate", "--backend", "tpu", *args], writer=w)
    return rc, w.stripped(), w.err_to_stripped()


def run_port(args):
    """(rc, stdout, stderr), the Evaluation and the K3 launches (the
    rim_reduce wrapper's calls)."""
    calls = []
    real = K.rim_reduce

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    w = Writer.buffered()
    _Recording.last = None
    with mock.patch.object(port_cli, "Validate", _Recording), \
            mock.patch.object(K, "rim_reduce", counting):
        rc = port_cli.run(["validate", "--device", "cpu", "--no-result-cache", *args],
                          writer=w)
    return (rc, w.stripped(), w.err_to_stripped()), _Recording.last.last_evaluation, calls


@pytest.mark.parametrize("flags", list(FLAG_SETS))
@pytest.mark.parametrize("shape", SHAPES)
def test_same_bytes_as_jax(fixture_args, shape, flags):
    args = [*fixture_args, *FLAG_SETS[flags], "--mesh-shape", shape]
    want = run_jax(args)
    got, _ev, _calls = run_port(args)
    assert got == want


@pytest.mark.parametrize("shape", ["off", "auto", "1x1", "1x2", "2x1", "4x1", "16x1"])
def test_every_shape_runs_unsharded_on_one_card(fixture_args, shape):
    """Every shape is the unsharded run: one K3 launch per (pack,
    bucket), every status and rim block back, the same counters and no
    per-shard gauge."""
    telemetry.REGISTRY.reset()
    base, ev0, calls0 = run_port(fixture_args)
    snap0 = telemetry.REGISTRY.snapshot()
    telemetry.REGISTRY.reset()
    got, ev, calls = run_port([*fixture_args, "--mesh-shape", shape])
    snap = telemetry.REGISTRY.snapshot()
    assert got == base
    assert len(ev.packs) == 1
    assert len(calls) == len(calls0) == len(ev.groups)
    packed = [ev.files[fi] for fi in ev.packs[0]]
    assert all(fr.statuses is not None and all(b is not None for b in fr.rim)
               for fr in packed)
    assert snap["counters"]["efficiency"] == snap0["counters"]["efficiency"]
    assert snap["counters"]["dispatch"] == snap0["counters"]["dispatch"]
    assert not [k for k in snap["gauges"] if k.startswith("efficiency.shard_")]


@pytest.mark.parametrize("raw", ["", "auto", "AUTO", "off", "none", "0", "1", "1x1", "2x1",
                                 " 2 x 1 ", "4x1", "1x2", "2x4", "8x1", "9x9", "0x1", "1x0",
                                 "2by1", "x", "2x1x1"])
@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_resolve_mesh_shape_matches_jax(monkeypatch, raw, n_devices):
    """The shape grammar: the same shape, or the same ValueError, as the
    JAX package's for the same device count."""
    monkeypatch.setenv("GUARD_TPU_MESH", raw)
    try:
        want = ("ok", jax_mesh2d.resolve_mesh_shape(n_devices))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", mesh2d.resolve_mesh_shape(raw, n_devices))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


@pytest.mark.parametrize("raw", ["1x2", "3x2", "2x16"])
def test_wide_shape_warns_like_jax(monkeypatch, caplog, raw):
    """A shape with more pack columns than devices logs the JAX
    package's warning, word for word, and falls back to unsharded."""
    monkeypatch.setenv("GUARD_TPU_MESH", raw)
    with caplog.at_level("WARNING"):
        assert jax_mesh2d.resolve_mesh_shape(1) is None
        assert mesh2d.resolve_mesh_shape(raw, 1) is None
    msgs = [r.getMessage() for r in caplog.records if "pack columns" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]


@pytest.mark.parametrize("bad", ["2by1", "x1"])
def test_malformed_shape_raises_like_jax(fixture_args, bad):
    """A malformed value is the JAX package's ValueError, raised where
    the JAX package raises it (the packed dispatch), out of the CLI."""
    args = [*fixture_args, "--mesh-shape", bad]
    with pytest.raises(ValueError) as jax_err:
        run_jax(args)
    with pytest.raises(ValueError) as port_err:
        run_port(args)
    assert str(port_err.value) == str(jax_err.value)


def test_malformed_shape_without_a_pack_is_not_read(tmp_path):
    """With one rules file there is no pack, so neither package reads
    the shape: the run succeeds with the same bytes."""
    root = write_fixture(tmp_path)
    args = ["-r", str(root / "rules" / "security.guard"), "-d", str(root / "data"),
            "--mesh-shape", "2by1"]
    want = run_jax(args)
    got, _ev, _calls = run_port(args)
    assert got == want


def test_device_count_of_the_cpu_is_one():
    assert mesh2d.device_count("cpu") == 1
