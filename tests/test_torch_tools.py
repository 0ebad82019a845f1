"""The port's small tools against the JAX package's.

  * `guard_tpu_torch/tools/check_metrics_schema.py` finds the problems
    `tools/check_metrics_schema.py` finds, on a snapshot of the port's
    telemetry registry and on snapshots broken one way each; its
    command's exit codes.
  * `python -m guard_tpu_torch.tools.perf_ledger` over the committed
    `bench_all_r*.json` appends the JAX tool's record count, artifacts
    and records (less the version and the device census); without a
    ledger destination it exits 1.
  * No module under guard_tpu_torch/tools/ imports jax, the JAX package
    or the JAX package's tools, in its source or in a process that ran
    its `main`.
"""

import ast
import copy
import json
import os
import pathlib
import subprocess
import sys

import pytest

from guard_tpu_torch.tools import check_metrics_schema as port_checker

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = REPO / "guard_tpu_torch" / "tools"
sys.path.insert(0, str(REPO / "tools"))
import check_metrics_schema as jax_checker  # noqa: E402

# top-level names the port's tools must never import
FORBIDDEN = ("jax", "jaxlib", "guard_tpu", "tools", "kernel_fuzz", "fuzz", "check_metrics_schema",
             "perf_ledger", "ts_build", "check_bench_schema", "bench")


def _port_snapshot() -> dict:
    from guard_tpu_torch.parallel import device  # noqa: F401 (registers dispatch, efficiency)
    from guard_tpu_torch.utils import telemetry

    telemetry.REGISTRY.observe_span("encode", 0.002)
    telemetry.REGISTRY.observe_span("dispatch", 0.5)
    return json.loads(json.dumps(telemetry.REGISTRY.snapshot()))


def _broken(kind: str, snap: dict) -> dict:
    snap = copy.deepcopy(snap)
    if kind == "version":
        snap["schema_version"] = 6
    elif kind == "section":
        del snap["spans"]
    elif kind == "counter":
        next(iter(snap["counters"].values()))["bogus"] = "many"
    elif kind == "buckets":
        hist = snap["histograms"]["stage.encode"]
        hist["count"] += 1
    elif kind == "labels":
        hist = snap["histograms"]["stage.encode"]
        hist["buckets"] = {"inf": 0, **hist["buckets"], "le_2^-30s": 0}
    elif kind == "shard_gauge":
        snap["gauges"]["efficiency.shard_0.doc_fil"] = 1.0
        snap["gauges"]["efficiency.shard_1.doc_fill"] = 2.0
    elif kind == "span":
        del snap["histograms"]["stage.dispatch"]
    return snap


@pytest.mark.parametrize("kind", ["valid", "version", "section", "counter", "buckets",
                                  "labels", "shard_gauge", "span"])
def test_metrics_checker_finds_what_the_jax_checker_finds(kind):
    snap = _port_snapshot()
    doc = snap if kind == "valid" else _broken(kind, snap)
    got = port_checker.check_snapshot(doc)
    assert got == jax_checker.check_snapshot(doc)
    assert bool(got) == (kind != "valid"), got
    groups = ("dispatch", "efficiency", "fault", "admission", "resume", "gc")
    assert port_checker.check_snapshot(doc, groups) == jax_checker.check_snapshot(doc, groups)
    assert port_checker.EXPECTED_GROUPS == jax_checker.EXPECTED_GROUPS


def test_metrics_checker_version_is_the_port_telemetrys():
    from guard_tpu_torch.utils.telemetry import SCHEMA_VERSION

    assert port_checker.KNOWN_SCHEMA_VERSION == SCHEMA_VERSION == jax_checker.KNOWN_SCHEMA_VERSION


def test_metrics_checker_command(tmp_path):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(_port_snapshot()))
    bad.write_text(json.dumps(_broken("version", _port_snapshot())))

    def run(*args):
        return subprocess.run([sys.executable, "-m", "guard_tpu_torch.tools.check_metrics_schema",
                               *map(str, args)], cwd=str(REPO), capture_output=True, text=True,
                              timeout=120)

    ok = run(good)
    assert ok.returncode == 0 and f"{good}: ok (schema_version 7)" in ok.stdout
    fail = run(good, bad, tmp_path / "missing.json")
    assert fail.returncode == 1
    assert "schema_version 6 != 7" in fail.stderr and "does not exist" in fail.stderr
    assert run().returncode == 2


def _ledger_run(argv, ledger_dir, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    env.pop("GUARD_TPU_LEDGER_DIR", None)
    if ledger_dir is not None:
        env["GUARD_TPU_LEDGER_DIR"] = str(ledger_dir)
    return subprocess.run([sys.executable, *argv], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300)


def test_perf_ledger_command_matches_the_jax_tool(tmp_path):
    from guard_tpu_torch.utils import ledger

    port = _ledger_run(["-m", "guard_tpu_torch.tools.perf_ledger"], tmp_path / "port")
    jax = _ledger_run([str(REPO / "tools" / "perf_ledger.py")], tmp_path / "jax")
    assert port.returncode == 0 and jax.returncode == 0, port.stderr + jax.stderr
    p, j = json.loads(port.stdout), json.loads(jax.stdout)
    assert p["records_appended"] == j["records_appended"] > 0
    assert p["artifacts"] == j["artifacts"] == [
        f"bench_all_r{n}.json" for n in sorted(
            int(a.stem.split("_r")[1]) for a in REPO.glob("bench_all_r*.json"))]
    assert p["ledger"] == str(tmp_path / "port" / "ledger.jsonl")
    recs_p = ledger.read_ledger(p["ledger"])
    recs_j = ledger.read_ledger(j["ledger"])
    assert len(recs_p) == len(recs_j) == p["records_appended"]
    skip = ("guard_tpu_version", "device_census")
    for a, b in zip(recs_p, recs_j):
        assert {k: v for k, v in a.items() if k not in skip} == \
            {k: v for k, v in b.items() if k not in skip}
        assert a["kind"] == "bench" and a["extra"]["backfilled"] is True


def test_perf_ledger_command_refuses_without_a_destination(tmp_path):
    proc = _ledger_run(["-m", "guard_tpu_torch.tools.perf_ledger"], None)
    assert proc.returncode == 1 and "GUARD_TPU_LEDGER_DIR" in proc.stderr
    bad = tmp_path / "bench_all_r99.json"
    bad.write_text('{"metric": "m", "value": 1}\nnot json\n')
    proc = _ledger_run(["-m", "guard_tpu_torch.tools.perf_ledger", str(bad)], tmp_path / "l")
    assert proc.returncode == 1 and "unparseable line" in proc.stderr
    proc = _ledger_run(["-m", "guard_tpu_torch.tools.perf_ledger", str(tmp_path / "none.json")],
                       tmp_path / "l")
    assert proc.returncode == 1 and "does not exist" in proc.stderr


@pytest.mark.parametrize("path", sorted(p.name for p in TOOLS.glob("*.py")))
def test_tool_source_imports_nothing_of_jax(path):
    tree = ast.parse((TOOLS / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


_MAIN = (
    "import importlib, sys\n"
    "mod = importlib.import_module('guard_tpu_torch.tools.' + sys.argv[1])\n"
    "rc = mod.main(sys.argv[2:])\n"
    "forbidden = {forbidden!r}\n"
    "leaked = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)\n"
    "print('LEAKED', leaked)\n"
    "sys.exit(rc)\n"
).format(forbidden=FORBIDDEN)


@pytest.mark.parametrize("tool", ["check_metrics_schema", "perf_ledger", "ts_build"])
def test_tool_main_imports_nothing_of_jax(tool, tmp_path):
    args = {
        "check_metrics_schema": [str(tmp_path / "snap.json")],
        "perf_ledger": [],
        "ts_build": ["--check"],
    }[tool]
    (tmp_path / "snap.json").write_text(json.dumps(_port_snapshot()))
    env = dict(os.environ, GUARD_TPU_LEDGER_DIR=str(tmp_path / "ledger"))
    proc = subprocess.run([sys.executable, "-c", _MAIN, tool, *args], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
