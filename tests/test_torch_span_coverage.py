"""The port's own spans: where they open, on which lane, under which
parent, and the one span clock.

CPU tests run a traced `sweep --device cpu` over the fixture of
tests/test_torch_reports.py, on the serial path (`--ingest-workers 0`)
and on the pipeline with two ingest workers and four chunks, and check
that the device phase's spans (`columnarize`, `h2d_copy`,
`walk_enqueue`, `device_wait`) open under a `dispatch` or `collect`,
that every main-lane span lies inside the one `sweep` root, and that
`ingest_wait` opens once for each chunk a worker prefetched. The
benchmark's readers of those spans are held on a synthetic run.

One test needs a CUDA card and carries the `cuda` marker: a span
around a sleeping kernel and its synchronize holds the kernel's
interval on the card's own trace. The module imports no JAX (the CPU
tests take the fixture's helpers when they run), so on a card:

    python -m pytest --noconftest -m cuda tests/test_torch_span_coverage.py
"""

import importlib
import json
import pathlib
import time

import pytest

from guard_tpu_torch.utils import telemetry

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the port's own spans and the lane each lands on
LANES = {
    "columnarize": "dispatch",
    "h2d_copy": "dispatch",
    "walk_enqueue": "dispatch",
    "device_wait": "collect",
    "sweep": "main",
    "sweep_scan": "main",
    "ingest_wait": "ingest",
    "chunk_fold": "main",
    "journal_close": "main",
}

#: (flags, the port's spans the run opens)
RUNS = {
    "serial": (["--ingest-workers", "0"], set(LANES) - {"ingest_wait"}),
    "pipelined": (["--ingest-workers", "2", "-c", "4"], set(LANES)),
}

#: the rounding of a trace event's microseconds
EPS_US = 0.002


def traced_sweep(tmp: pathlib.Path, flags):
    """One traced sweep over the fixture: (rc, spans, snapshot), spans
    as dicts with name, lane, sid, parent, start and end (us)."""
    from guard_tpu_torch import cli
    from guard_tpu_torch.ops import plan
    from guard_tpu_torch.parallel import ingest
    from guard_tpu_torch.utils import faults
    from guard_tpu_torch.utils.io import Reader, Writer
    from test_torch_ingest import set_encoders
    from test_torch_reports import write_fixture

    with pytest.MonkeyPatch.context() as mp:
        for name, sub in (("GUARD_TPU_FLIGHTREC_DIR", "flightrec"),
                          ("GUARD_TPU_PLAN_CACHE_DIR", "plans"),
                          ("GUARD_TPU_JOURNAL_DIR", "journal"),
                          ("GUARD_TPU_RESULT_CACHE_DIR", "results")):
            mp.setenv(name, str(tmp / sub))
        mp.setenv("GUARD_TPU_RESULT_CACHE", "0")
        mp.setenv("GUARD_TPU_RETRY_BACKOFF", "0")
        mp.delenv("GUARD_TPU_FAULT", raising=False)
        set_encoders(mp, None, tmp)
        root = write_fixture(tmp)
        trace, metrics = tmp / "trace.json", tmp / "metrics.json"
        plan.clear_plan_memo()
        telemetry.reset_metrics()
        faults.reset_faults()
        try:
            rc = cli.run(["sweep", "-r", str(root / "rules"), "-d", str(root / "data"),
                          "-M", str(tmp / "manifest.jsonl"), "--device", "cpu", *flags,
                          "--trace-out", str(trace), "--metrics-out", str(metrics)],
                         writer=Writer.buffered(), reader=Reader.from_string(""))
        finally:
            # the pool lives on with the environment it was spawned in
            ingest.close_shared_pools()
            plan.clear_plan_memo()
    events = json.loads(trace.read_text())["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = [
        {"name": e["name"], "lane": lanes[e["tid"]], "sid": e["args"]["sid"],
         "parent": e["args"].get("parent", 0), "start": e["ts"], "end": e["ts"] + e["dur"]}
        for e in events if e["ph"] == "X"
    ]
    return rc, spans, json.loads(metrics.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for key, (flags, _names) in RUNS.items():
        out[key] = traced_sweep(tmp_path_factory.mktemp(key), flags)
    return out


def inside(inner, outer) -> bool:
    return (inner["start"] >= outer["start"] - EPS_US
            and inner["end"] <= outer["end"] + EPS_US)


@pytest.mark.parametrize("key", list(RUNS))
def test_every_new_span_is_on_its_lane(runs, key):
    rc, spans, _snap = runs[key]
    assert rc == 19  # the fixture has failing templates
    ours = [s for s in spans if s["name"] in LANES]
    assert {s["name"] for s in ours} == RUNS[key][1]
    for s in ours:
        assert s["lane"] == LANES[s["name"]], s


@pytest.mark.parametrize("key", list(RUNS))
def test_device_phase_spans_open_under_a_dispatch(runs, key):
    _rc, spans, _snap = runs[key]
    by_sid = {s["sid"]: s for s in spans}
    seen = set()
    for s in spans:
        if s["name"] in ("columnarize", "h2d_copy", "walk_enqueue"):
            parent = by_sid[s["parent"]]
            assert parent["name"] == "dispatch", s
            assert inside(s, parent), (s, parent)
            seen.add(s["name"])
        elif s["name"] == "device_wait":
            parent = by_sid[s["parent"]]
            assert parent["name"] in ("dispatch", "collect"), s
            assert inside(s, parent), (s, parent)
            seen.add(s["name"])
    assert seen == {"columnarize", "h2d_copy", "walk_enqueue", "device_wait"}
    # every walk was columnarized and copied once
    count = lambda n: sum(s["name"] == n for s in spans)
    assert count("columnarize") == count("h2d_copy") >= 1


@pytest.mark.parametrize("key", list(RUNS))
def test_every_main_lane_span_lies_inside_the_one_sweep_root(runs, key):
    _rc, spans, _snap = runs[key]
    roots = [s for s in spans if s["name"] == "sweep"]
    assert len(roots) == 1 and roots[0]["parent"] == 0
    root = roots[0]
    main = [s for s in spans if s["lane"] == "main" and s is not root]
    assert {"sweep_scan", "chunk_fold", "journal_close", "journal_key"} <= {
        s["name"] for s in main}
    for s in main:
        assert inside(s, root), s
    # the directory's listing and the signatures: two scans, children of
    # the root
    scans = [s for s in spans if s["name"] == "sweep_scan"]
    assert len(scans) == 2 and all(s["parent"] == root["sid"] for s in scans)


@pytest.mark.parametrize("key", list(RUNS))
def test_chunk_fold_holds_the_tally_and_not_the_device_phase(runs, key):
    _rc, spans, snap = runs[key]
    by_sid = {s["sid"]: s for s in spans}
    folds = [s for s in spans if s["name"] == "chunk_fold"]
    assert len(folds) == snap["counters"]["resume"]["chunks_journaled"] >= 1
    for s in spans:
        if s["name"] in ("rim_reduce", "journal_append"):
            assert by_sid[s["parent"]]["name"] == "chunk_fold", s
        if s["name"] in ("dispatch", "collect") + tuple(
                n for n, lane in LANES.items() if lane in ("dispatch", "collect")):
            assert not any(inside(s, f) for f in folds), s


def test_ingest_wait_opens_once_for_each_prefetched_chunk(runs):
    _rc, spans, snap = runs["pipelined"]
    waits = [s for s in spans if s["name"] == "ingest_wait"]
    pipeline = snap["counters"]["pipeline"]
    assert len(waits) == pipeline["chunks_prefetched"] >= 2
    # the span covers the interval the stall counter counts
    total = sum(s["end"] - s["start"] for s in waits) * 1e-6
    assert total >= pipeline["ingest_stall_seconds"] - len(waits) * 1e-8
    assert total - pipeline["ingest_stall_seconds"] < 0.05
    root = next(s for s in spans if s["name"] == "sweep")
    assert all(inside(s, root) for s in waits)


# ------------------------------------------------ the benchmark's readers

#: metric -> the span it reads
READERS = {
    "columnarize_span_ms_per_kdoc": "columnarize",
    "h2d_ms_per_kdoc": "h2d_copy",
    "enqueue_ms_per_kdoc": "walk_enqueue",
    "device_wait_ms_per_kdoc": "device_wait",
    "scan_ms_per_kdoc": "sweep_scan",
    "fold_ms_per_kdoc": "chunk_fold",
}


@pytest.mark.parametrize("metric", list(READERS))
def test_each_reader_reads_its_span_per_1000_documents(metric):
    from portbench.harness.record import Run

    read = importlib.import_module(f"portbench.metrics.{metric}").read
    spans = {"dispatch": 9.0, READERS[metric]: 0.75}
    assert read(Run(docs=3000, window_s=30.0, spans=spans)) == pytest.approx(250.0)
    # absent: the parent's program opens no such span
    assert read(Run(docs=3000, window_s=30.0, spans={"dispatch": 9.0})) is None
    assert read(Run(docs=0, window_s=30.0, spans=spans)) is None


def test_the_readers_are_declared_as_program_spans():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for metric, _span in READERS.items():
        m = declared[metric]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span", "card_ms_per_kdoc", "ms")
        assert (ROOT / "portbench" / "metrics" / f"{metric}.py").is_file()


# ------------------------------------------------------- the span clock

@pytest.fixture
def tracing(monkeypatch):
    monkeypatch.setattr(telemetry, "_ON", False)
    telemetry.enable()
    telemetry.reset_trace()
    yield
    telemetry.disable()
    telemetry.reset_trace()


def test_consecutive_spans_end_in_order_and_open_at_their_wall_time(tracing):
    opened = []
    for i in range(50):
        wall = time.time()
        with telemetry.span("clock_probe", {"i": i}):
            opened.append(wall)
    recs = sorted(telemetry._TRACE, key=lambda r: r["sid"])
    assert len(recs) == 50
    ends = [r["ts"] + r["dur"] for r in recs]
    assert ends == sorted(ends)
    for a, b in zip(recs, recs[1:]):
        assert b["ts"] >= a["ts"] + a["dur"]
    for wall, r in zip(opened, recs):
        assert abs(telemetry._EPOCH + r["ts"] - wall) < 1e-3


def test_a_wall_clock_step_shifts_no_span(tracing, monkeypatch):
    with telemetry.span("clock_probe"):
        pass
    real = time.time
    monkeypatch.setattr(time, "time", lambda: real() + 3600.0)
    with telemetry.span("clock_probe"):
        pass
    first, second = sorted(telemetry._TRACE, key=lambda r: r["sid"])
    assert 0 <= second["ts"] - (first["ts"] + first["dur"]) < 1.0


def test_the_flight_recorder_maps_the_span_clock_onto_the_wall(monkeypatch):
    monkeypatch.setattr(telemetry, "_ON", False)
    monkeypatch.setattr(telemetry, "_FR_ON", True)
    telemetry.flightrec_reset()
    wall = time.time()
    with telemetry.span("clock_probe"):
        pass
    slot = telemetry._FLIGHTREC.snapshot()[-1]
    telemetry.flightrec_reset()
    assert slot[2] == "clock_probe"
    assert abs(slot[4] - wall) < 1e-3


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
def test_a_span_holds_its_kernel_on_the_cards_trace():
    """A span around a sleeping kernel and its synchronize holds the
    kernel's interval on the card's trace (torch.profiler, anchored on
    the wall clock as the benchmark anchors it) to within 200 us."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's trace has no CPU mode")
    from portbench.harness.trace import DeviceTrace, SpanTimeline

    dev = torch.device("cuda", 0)
    # the first launch of a kernel loads it: load the sleeping kernel,
    # and the trace's marker (a fill), whose launch anchors the card's
    # clock on the wall clock, before the trace starts
    torch.cuda._sleep(1000)
    torch.zeros(1, device=dev).fill_(1.0)
    torch.cuda.synchronize(dev)
    card, timeline = DeviceTrace(dev), SpanTimeline()
    card.start()
    timeline.start()
    try:
        time.sleep(0.01)
        with telemetry.span("clock_probe"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(dev)
        time.sleep(0.01)
    finally:
        timeline.stop()
        card.stop()
    span = next(s for s in timeline.spans if s.name == "clock_probe")
    kernel = max(card.events, key=lambda e: e.end - e.start)
    assert kernel.end - kernel.start > 1e-3, card.events
    assert kernel.start >= span.start - 200e-6, (kernel, span)
    assert kernel.end <= span.end + 200e-6, (kernel, span)
