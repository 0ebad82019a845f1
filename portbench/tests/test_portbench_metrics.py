"""Each metric reader on a recorded telemetry snapshot and a synthetic
profiler trace, and the trace's reduction to busy time, idle gaps and
the breakdown."""

import json

import pytest

from portbench.harness import spec as spec_mod
from portbench.harness.kernels import k1_bytes, k3_bytes, wrapper_of
from portbench.harness.record import Run, breakdown
from portbench.harness.trace import DeviceEvent, Span, SpanTimeline, busy_intervals, idle_gaps
from portbench.tests.conftest import ROOT

SPEC = spec_mod.load(ROOT, "secpol.sweep")

# span totals and pipeline counters as a traced CPU rehearsal records
# them (seconds)
SNAPSHOT = {
    "spans": {"journal_key": 0.0298, "journal_append": 0.0061, "lower_compile": 1.088,
              "load_plan": 0.0001, "relocate": 0.0254, "dispatch": 3.804, "collect": 0.0054},
    "counters": {"pipeline": {"chunks_prefetched": 2, "ingest_stall_seconds": 0.25}},
}
W0 = 1000.0  # the window's start on the host's wall clock


def traced_run():
    events = [
        DeviceEvent("void gather_rows_kernel(int const*, int const*, int*, int, int, int)", W0 + 0.10, W0 + 0.10002),
        DeviceEvent("void rim_warp_kernel(RimArgs)", W0 + 0.20, W0 + 0.20004),
        DeviceEvent("Memcpy HtoD (Pageable -> Device)", W0 + 0.30, W0 + 0.31),
        DeviceEvent("void at::native::vectorized_elementwise_kernel<4>", W0 + 0.305, W0 + 0.32),
        DeviceEvent("void gather_rows_kernel(int const*, int const*, int*, int, int, int)", W0 + 5.0, W0 + 5.1),
    ]
    launches = [("gather_rows", k1_bytes(1024, 64, 64)), ("rim_reduce", k3_bytes(1024, 253, 253, 245))]
    return Run(docs=2048, window_s=2.0, spans=dict(SNAPSHOT["spans"]), counters=SNAPSHOT["counters"],
               timers={"columnarize": 0.5}, launches=launches, device_events=events,
               window=(W0, W0 + 2.0), busy=busy_intervals(events, W0, W0 + 2.0),
               device_name="NVIDIA H100 80GB HBM3", setup_s=31.5)


def read(name, run):
    return SPEC.reader(name)(run)


def test_span_and_counter_readers_normalise_per_1000_documents():
    run = traced_run()
    assert read("journal_ms_per_kdoc", run) == pytest.approx((0.0298 + 0.0061) * 1e6 / 2048)
    assert read("lower_ms_per_kdoc", run) == pytest.approx((1.088 + 0.0001 + 0.0254) * 1e6 / 2048)
    assert read("dispatch_ms_per_kdoc", run) == pytest.approx(3.804 * 1e6 / 2048)
    assert read("ingest_stall_ms_per_kdoc", run) == pytest.approx(0.25 * 1e6 / 2048)
    assert read("columnarize_ms_per_kdoc", run) == pytest.approx(0.5 * 1e6 / 2048)
    assert read("sweep_docs_per_s", run) == 1024.0 and read("setup_s", run) == 31.5


def test_device_readers_on_a_synthetic_trace():
    run = traced_run()
    # busy: [0.10, 0.10002], [0.20, 0.20004], [0.30, 0.32]; the event at
    # 5 s lies outside the window
    busy = 0.00002 + 0.00004 + 0.02
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - busy / 2.0))
    assert read("card_ms_per_kdoc", run) == pytest.approx(1e6 * busy / 2048)
    want = 100 * (k1_bytes(1024, 64, 64) + k3_bytes(1024, 253, 253, 245)) / 3.35e12 / 0.00006
    assert read("guard_kernels_roofline", run) == pytest.approx(want)


def test_readers_that_find_nothing_return_nothing():
    empty = Run(docs=1024, window_s=1.0)
    # the sweep's rate reads only the window's documents and seconds
    for m in SPEC.per_layer + SPEC.end_to_end:
        if m.name not in ("sweep_docs_per_s", "setup_s"):
            assert read(m.name, empty) is None, m.name
    assert read("guard_kernels_roofline", Run(docs=1, window_s=1.0, launches=[("gather_rows", 10)],
                                              device_name="a card without published peaks")) is None


def test_kernel_names_map_to_their_wrappers():
    assert wrapper_of("void segment_sum_split_kernel<32>(int const*)") == "segment_sum_rows"
    assert wrapper_of("rule_summary_cluster_kernel") == "rule_summary"
    assert wrapper_of("void set_count_probe_kernel(int const*)") == "set_count_rows"
    assert wrapper_of("void at::native::elementwise_kernel<128, 2>") is None
    assert wrapper_of("my_gather_rows_kernel") is None


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    run = traced_run()
    spans = SpanTimeline([Span("dispatch", W0, W0 + 1.0, "dispatch"),
                          Span("lower_compile", W0 + 0.25, W0 + 0.5, "rules"),
                          Span("journal_key", W0 + 1.5, W0 + 1.6, "main")])
    b = breakdown(run, spans)
    idle = dict(b["idle_gaps"])
    assert idle["lower_compile"] == pytest.approx(0.05 + 0.18)  # 0.25-0.30 and 0.32-0.50
    assert idle["journal_key"] == pytest.approx(0.1)
    total = sum(t - s for s, t in idle_gaps(run.busy, W0, W0 + 2.0))
    assert sum(idle.values()) == pytest.approx(total)
    ops = dict(b["device_ops"])
    assert len(b["device_ops"]) <= 10 and ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(0.01)
    json.dumps(b)
