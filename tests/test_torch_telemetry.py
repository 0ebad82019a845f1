"""The port's telemetry plane (guard_tpu_torch/utils/telemetry.py, the
counter groups and the spans at the JAX package's sites, `--trace-out`
and `--metrics-out`) against the JAX package's, on the CPU.

For each flag set both CLIs run in this process with both registries
reset first: the port's snapshot passes tools/check_metrics_schema.py
and the port's own checker (guard_tpu_torch/tools/check_metrics_schema.py),
every counter both packages keep (same group, same key) has the same
value, and the multiset of (span name, lane) pairs is the same for the
span names both packages emit. Times are not compared. The trace is
Chrome trace_event JSON with the lanes of `_LANE_ORDER`, the instant
event lane and one lane per ingest worker.
"""

import collections
import json
import os
import pathlib
import subprocess
import sys

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.ops import plan as jax_plan
from guard_tpu.utils import faults as jax_faults
from guard_tpu.utils import telemetry as jax_telemetry
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.utils import faults as port_faults
from guard_tpu_torch.utils import telemetry
from guard_tpu_torch.utils.io import Writer
from test_torch_reports import set_native, write_fixture
from guard_tpu_torch.tools.check_metrics_schema import check_snapshot as port_check_snapshot
from tools.check_metrics_schema import check_snapshot

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the groups every snapshot of a port run on the device path carries
PORT_GROUPS = ("dispatch", "efficiency", "rim", "fault", "plan_cache", "result_cache",
               "analysis", "serve", "admission", "resume", "gc")

FLAG_SETS = {
    "statuses_only": ["--statuses-only"],
    "single_line_all": ["-S", "all"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
    "no_pack": ["--no-pack", "--statuses-only"],
    "no_vector_rim": ["--no-vector-rim"],
    "no_plan_cache": ["--no-plan-cache", "--statuses-only"],
    "quarantine": ["--max-doc-failures", "0"],
    "result_cache": ["--statuses-only", "@cache"],
    "ingest_pool": ["--ingest-workers", "2", "--statuses-only"],
    "fault_dispatch": ["--statuses-only", "@fault=dispatch:nth=1"],
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    # an rc-5 run dumps here if the flight recorder is armed
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)
    set_native(monkeypatch, None)
    port_plan.clear_plan_memo()
    yield
    port_plan.clear_plan_memo()


def run_traced(monkeypatch, tmp_path, flags):
    """Both CLIs with --trace-out and --metrics-out after both registries
    were reset: {package: (rc, stdout, stderr, trace, snapshot)}."""
    root = write_fixture(tmp_path)
    args = ["-r", str(root / "rules"), "-d", str(root / "data")]
    port_extra = []
    for f in flags:
        if f == "@cache":
            monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "1")
        elif f.startswith("@fault="):
            monkeypatch.setenv("GUARD_TPU_FAULT", f[len("@fault="):])
        else:
            args.append(f)
    if "@cache" not in flags:
        port_extra.append("--no-result-cache")
    out = {}
    for who in ("jax", "port"):
        trace, metrics = tmp_path / f"{who}.trace.json", tmp_path / f"{who}.metrics.json"
        argv = ["validate", *args, "--trace-out", str(trace), "--metrics-out", str(metrics)]
        monkeypatch.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(tmp_path / f"{who}_results"))
        if who == "jax":
            jax_plan.clear_plan_memo()
            jax_telemetry.reset_metrics()
            jax_faults.reset_faults()
            w = JaxWriter.buffered()
            rc = jax_cli.run([*argv, "--backend", "tpu"], writer=w)
        else:
            telemetry.reset_metrics()
            port_faults.reset_faults()
            w = Writer.buffered()
            rc = port_cli.run([*argv, "--device", "cpu", *port_extra], writer=w)
        out[who] = (rc, w.stripped(), w.err_to_stripped(), json.loads(trace.read_text()),
                    json.loads(metrics.read_text()))
    return out


def span_multiset(trace):
    """Counter of (name, lane) over the completed spans; worker lanes
    fold into one label (their pids differ between runs)."""
    lanes = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    return collections.Counter(
        (e["name"], "worker" if lanes[e["tid"]].startswith("worker-") else lanes[e["tid"]])
        for e in trace["traceEvents"] if e["ph"] == "X"
    )


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_counters_and_spans_match_jax(monkeypatch, tmp_path, flags):
    runs = run_traced(monkeypatch, tmp_path, FLAG_SETS[flags])
    (j_rc, j_out, j_err, j_trace, j_snap) = runs["jax"]
    (p_rc, p_out, p_err, p_trace, p_snap) = runs["port"]
    assert (p_rc, p_out, p_err) == (j_rc, j_out, j_err)
    # the snapshot's schema, with every group of the port
    assert check_snapshot(p_snap, require_groups=PORT_GROUPS) == []
    assert port_check_snapshot(p_snap, require_groups=PORT_GROUPS) == []
    assert p_snap["schema_version"] == j_snap["schema_version"]
    # the counters both packages keep
    shared = 0
    for group, vals in p_snap["counters"].items():
        j_vals = j_snap["counters"].get(group)
        if j_vals is None:
            continue
        for key, value in vals.items():
            if key in j_vals and group not in ("dispatch", "efficiency"):
                assert value == j_vals[key], f"{group}.{key}"
                shared += 1
    assert shared >= 30
    # the spans both packages emit, by name and lane; the port reads
    # and writes a run's cache entries in one batch each, where the JAX
    # package opens a span per entry
    p_spans, j_spans = span_multiset(p_trace), span_multiset(j_trace)
    cache_spans = {"cache_lookup", "cache_store"}
    if "@cache" in FLAG_SETS[flags]:
        assert {k: v for k, v in p_spans.items() if k[0] in cache_spans} == {
            ("cache_lookup", "main"): 1, ("cache_store", "main"): 1}
        assert j_spans[("cache_lookup", "main")] == j_spans[("cache_store", "main")] == 15
    names = ({n for n, _ in p_spans} & {n for n, _ in j_spans}) - cache_spans
    assert {"read_parse", "rule_parse", "report"} <= names
    assert ({k: v for k, v in p_spans.items() if k[0] in names}
            == {k: v for k, v in j_spans.items() if k[0] in names})
    # every span roll-up is in the trace
    assert {n: r["count"] for n, r in p_snap["spans"].items()} == dict(
        collections.Counter(e["name"] for e in p_trace["traceEvents"] if e["ph"] == "X"))


def test_trace_is_chrome_trace_event_json(monkeypatch, tmp_path):
    runs = run_traced(monkeypatch, tmp_path, ["--ingest-workers", "2", "-S", "all"])
    trace = runs["port"][3]
    assert trace["otherData"]["tool"] == "guard-tpu-torch"
    events = trace["traceEvents"]
    assert {e["ph"] for e in events} <= {"M", "X", "i"}
    lanes = [e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"]
    assert len(lanes) == len(set(lanes))
    fixed = [l for l in lanes if not l.startswith("worker-")]
    assert set(fixed) <= set(telemetry._LANE_ORDER) | {"events"}
    assert {"rules", "ingest", "dispatch", "collect", "rim"} <= set(fixed)
    # both shards come back, each on the lane of the worker that took
    # it (a busy host may hand both to one of the two workers)
    lane_of = {e["tid"]: e["args"]["name"] for e in events
               if e["ph"] == "M" and e["name"] == "thread_name"}
    worker_spans = [e for e in events if e["ph"] == "X" and e["args"].get("worker")]
    assert sum(e["name"] == "encode" for e in worker_spans) == 2
    assert {lane_of[e["tid"]] for e in worker_spans} == {l for l in lanes
                                                         if l.startswith("worker-")}
    assert 1 <= sum(l.startswith("worker-") for l in lanes) <= 2
    for e in events:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0 and isinstance(e["args"]["sid"], int)


def test_collect_follows_its_dispatch(monkeypatch, tmp_path):
    """The collect span opens after the dispatch span closes (every
    (pack, bucket) is dispatched before any is collected)."""
    runs = run_traced(monkeypatch, tmp_path, ["--statuses-only"])
    xs = [e for e in runs["port"][3]["traceEvents"] if e["ph"] == "X"]
    dispatch = [e for e in xs if e["name"] == "dispatch"]
    collect = [e for e in xs if e["name"] == "collect"]
    assert len(dispatch) == len(collect) == 1
    assert collect[0]["ts"] >= dispatch[0]["ts"] + dispatch[0]["dur"] - 1


def test_metrics_written_when_the_run_fails(tmp_path):
    """The exports sit in the CLI's finally: an rc-5 run leaves both."""
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    w = Writer.buffered()
    rc = port_cli.run(["validate", "--device", "cpu", "-r", str(tmp_path / "none.guard"),
                       "-d", str(tmp_path), "--trace-out", str(trace),
                       "--metrics-out", str(metrics)], writer=w)
    assert rc == 5
    assert check_snapshot(json.loads(metrics.read_text())) == []
    assert port_check_snapshot(json.loads(metrics.read_text())) == []
    assert json.loads(trace.read_text())["traceEvents"]
    assert not telemetry.enabled()


def test_fault_counter_is_an_instant_event(monkeypatch, tmp_path):
    runs = run_traced(monkeypatch, tmp_path, ["--statuses-only", "@fault=collect:nth=1"])
    names = [e["name"] for e in runs["port"][3]["traceEvents"] if e["ph"] == "i"]
    assert "fault.injected_collect" in names and "fault.dispatch_fallbacks" in names
    assert runs["port"][4]["counters"]["fault"]["dispatch_fallbacks"] == 1


def test_flight_recorder_dumps_on_exit_5(monkeypatch, tmp_path):
    """With the recorder armed, an rc-5 validate dumps its ring and a
    snapshot into GUARD_TPU_FLIGHTREC_DIR, whose default is the port's
    own directory."""
    monkeypatch.setenv("GUARD_TPU_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "fr"))
    telemetry.flightrec_refresh()
    try:
        w = Writer.buffered()
        rc = port_cli.run(["validate", "--device", "cpu", "-r", str(tmp_path / "missing.guard"),
                           "-d", str(tmp_path)], writer=w)
    finally:
        monkeypatch.setenv("GUARD_TPU_FLIGHT_RECORDER", "0")
        telemetry.flightrec_refresh()
    assert rc == 5
    dumps = list((tmp_path / "fr").glob("flightrec-*.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["otherData"]["reason"] == "exit_code_5"
    assert doc["otherData"]["tool"] == "guard-tpu-torch"
    assert check_snapshot(doc["metrics"]) == []
    assert port_check_snapshot(doc["metrics"]) == []


def test_disabled_span_is_one_shared_object(monkeypatch):
    monkeypatch.setattr(telemetry, "_FR_ON", False)
    assert not telemetry.enabled()
    assert telemetry.span("dispatch") is telemetry.span("collect") is telemetry._NOOP
    assert telemetry.span_begin("rim_reduce") is telemetry._NOOP


def test_counter_groups_are_the_modules_dicts():
    """Each module's counter dict is its registered group: an increment
    shows in the snapshot and a reset clears it."""
    from guard_tpu_torch.analysis import ANALYSIS_COUNTERS
    from guard_tpu_torch.cache.results import RESULT_COUNTERS
    from guard_tpu_torch.ops.backend import RIM_COUNTERS
    from guard_tpu_torch.ops.plan import PLAN_COUNTERS
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS, EFFICIENCY_COUNTERS
    from guard_tpu_torch.utils.faults import FAULT_COUNTERS

    groups = {"analysis": ANALYSIS_COUNTERS, "result_cache": RESULT_COUNTERS,
              "rim": RIM_COUNTERS, "plan_cache": PLAN_COUNTERS,
              "dispatch": DISPATCH_COUNTERS, "efficiency": EFFICIENCY_COUNTERS,
              "fault": FAULT_COUNTERS}
    telemetry.reset_metrics()
    for name, d in groups.items():
        key = next(iter(d))
        d[key] += 3
        assert telemetry.REGISTRY.snapshot()["counters"][name][key] == 3
    assert isinstance(FAULT_COUNTERS, telemetry.EventedCounters)
    telemetry.reset_metrics()
    assert all(v == 0 for d in groups.values() for v in d.values())


def test_a_traced_run_imports_no_jax(tmp_path):
    """A traced run with the ingest pool imports no JAX in this process,
    and its workers' spans come back."""
    root = write_fixture(tmp_path)
    trace = tmp_path / "t.json"
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        "from guard_tpu_torch.parallel import ingest\n"
        "if __name__ == '__main__':\n"
        f"    rc = cli.run(['validate', '--device', 'cpu', '--ingest-workers', '2',\n"
        f"                  '-r', {str(root / 'rules')!r}, '-d', {str(root / 'data')!r},\n"
        f"                  '--trace-out', {str(trace)!r}])\n"
        "    ingest.close_shared_pools()\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu'))\n"
        "    print('RESULT', rc, bad)\n"
    )
    script = tmp_path / "traced.py"
    script.write_text(code)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(GUARD_TPU_RESULT_CACHE_DIR=str(tmp_path / "rc"), PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    assert line == ["RESULT 19 []"], proc.stderr[-2000:]
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e["ph"] == "X" and e["name"] == "encode" and e["args"].get("worker")
               for e in events) == 2
