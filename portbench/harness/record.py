"""The measured window and what a run reports from it.

The window opens when the first timed invocation starts and closes when
the first invocation that ends after `seconds` ends; invocations run
back to back over the cell's directories in turn. Every run on a card
records the card's activity over the window with the profiler, which
gives the end-to-end card time per document. A traced run (`--trace 1`)
also records the kernel launches, the columnarization timer and the
program's spans, and its line carries the per-layer metrics (the sweep's
rate among them) instead of the end-to-end ones.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import trace as tr


@dataclass
class Run:
    """What a metric reader reads: the window's documents and seconds,
    the set-up's seconds, the program's span totals and counters over
    the window, the benchmark's host timers, the launches' bytes and the
    card's trace."""

    docs: int
    window_s: float
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, dict] = field(default_factory=dict)
    timers: Dict[str, float] = field(default_factory=dict)
    launches: list = field(default_factory=list)
    device_events: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)  # host wall clock
    busy: list = field(default_factory=list)
    device_name: str = ""
    setup_s: float = 0.0


class Window:
    def __init__(self, spec, entry, pool, device, trace: bool):
        self.spec, self.entry, self.pool = spec, entry, pool
        self.device, self.trace = device, trace
        self.invocations: List[dict] = []
        self.run: Optional[Run] = None
        self.breakdown: Optional[dict] = None

    def measure(self, seconds: float) -> None:
        from guard_tpu_torch.ops.ir import CompiledRules
        from guard_tpu_torch.utils import telemetry

        telemetry.reset_metrics()
        on_card = self.device.type == "cuda"
        device_trace = tr.DeviceTrace(self.device) if on_card else None
        spans = tr.SpanTimeline() if self.trace else None
        recorder = tr.LaunchRecorder() if self.trace else None
        timer = tr.CallTimer(CompiledRules, "device_arrays") if self.trace else None
        if device_trace is not None:
            device_trace.start()
        if spans is not None:
            spans.start()
        if recorder is not None:
            recorder.__enter__()
            timer.__enter__()
        try:
            wall0 = time.time()
            t0 = time.perf_counter()
            k = 0
            before = stage_totals()
            while True:
                inv = self.entry.invoke(f"inv{k}", self.pool[k % len(self.pool)])
                self.invocations.append(inv)
                k += 1
                after = stage_totals()
                log_stages(inv, before, after)
                before = after
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
            wall1 = wall0 + window_s
        finally:
            if recorder is not None:
                timer.__exit__(None, None, None)
                recorder.__exit__(None, None, None)
            if spans is not None:
                spans.stop()
            if device_trace is not None:
                device_trace.stop()
        snap = telemetry.metrics_snapshot()
        run = Run(
            docs=sum(self.entry.documents(inv) for inv in self.invocations),
            window_s=window_s,
            spans={k: v["total_seconds"] for k, v in snap["spans"].items()},
            counters=snap["counters"],
            window=(wall0, wall1),
        )
        if self.trace:
            run.timers["columnarize"] = timer.seconds
            run.launches = recorder.launches
            totals = ", ".join(f"{k} {v:.3f}" for k, v in sorted(run.spans.items(), key=lambda kv: -kv[1]))
            print(f"portbench: the window's span totals (s): {totals}", file=sys.stderr)
            counts = {}
            for name, _b in run.launches:
                counts[name] = counts.get(name, 0) + 1
            print(f"portbench: the window's launches: {counts}", file=sys.stderr)
        if device_trace is not None:
            import torch

            run.device_events = device_trace.events
            run.busy = tr.busy_intervals(device_trace.events, wall0, wall1)
            run.device_name = torch.cuda.get_device_name(self.device)
            if self.trace:
                self.breakdown = breakdown(run, spans)
            print(f"portbench: trace anchor offset {device_trace.offset * 1e6:.1f} us, "
                  f"{len(device_trace.events)} device events, profiler stop "
                  f"{device_trace.stop_s:.3f} s, events read {device_trace.read_s:.3f} s",
                  file=sys.stderr)
        self.run = run

    def result(self, setup_s: float, memory_peak: int, checks: dict, found: dict) -> dict:
        run = self.run
        run.setup_s = setup_s
        metrics = {}
        for m in (self.spec.per_layer if self.trace else self.spec.end_to_end):
            value = self.spec.reader(m.name)(run)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        import torch

        device = {
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        }
        if self.trace and run.busy:
            device["busy_s"] = sum(t - s for s, t in run.busy)
            device["window_s"] = run.window_s
        failed = sum(self.entry.failed_documents(inv) for inv in self.invocations)
        out = {
            "correct": checks["correct"],
            "attempted": run.docs,
            "failed": failed,
            "metrics": metrics,
            "device": device,
        }
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["check"] = checks["numbers"]
        out["_found"] = found
        return out


def stage_totals() -> Dict[str, float]:
    """The program's span totals so far, and the ingest stall, seconds."""
    from guard_tpu_torch.utils import telemetry

    snap = telemetry.metrics_snapshot()
    out = {k: v["total_seconds"] for k, v in snap["spans"].items()}
    out["ingest_stall"] = float(snap["counters"].get("pipeline", {}).get("ingest_stall_seconds", 0.0))
    return out


def log_stages(inv: dict, before: Dict[str, float], after: Dict[str, float]) -> None:
    """One line on stderr: an invocation's seconds and its largest
    stages, so that a run's spread can be laid to a stage."""
    delta = {k: v - before.get(k, 0.0) for k, v in after.items()}
    top = sorted(delta.items(), key=lambda kv: -kv[1])[:6]
    print(f"portbench: {inv['label']} {inv['seconds']:.3f} s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in top), file=sys.stderr, flush=True)


def short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(run: Run, spans: Optional[tr.SpanTimeline]) -> dict:
    """The device operations that took most time and the card's idle
    time by the span open on the host, ten of each."""
    lo, hi = run.window
    by_op: Dict[str, float] = {}
    for e in run.device_events:
        s, t = max(e.start, lo), min(e.end, hi)
        if t > s:
            key = short(e.name)
            by_op[key] = by_op.get(key, 0.0) + (t - s)
    gaps = tr.idle_gaps(run.busy, lo, hi)
    by_span = spans.attribute(gaps) if spans is not None else {}
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}
