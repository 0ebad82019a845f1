"""What a traced run records around the window, from the benchmark's
side of the program:

  * `DeviceTrace`: the card's activity (kernels, copies, memsets) from
    `torch.profiler`, on the host's wall clock;
  * `LaunchRecorder`: the bytes of every launch of the hand-written
    kernels, from the arguments of the wrappers in
    guard_tpu_torch.kernels (the walk calls them through the module,
    so a wrapper replaced there is the one it calls);
  * `CallTimer`: host seconds inside one method of the program;
  * `SpanTimeline`: the program's telemetry spans of the window, which
    label the card's idle gaps by what the host was doing.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .kernels import BYTES


@dataclass
class DeviceEvent:
    name: str
    start: float  # seconds on the host's wall clock (time.time)
    end: float


class DeviceTrace:
    """torch.profiler over CUDA activity alone. The trace is anchored on
    the host's wall clock by one marker launch on an idle card right
    after the profiler starts: the first device event is the marker."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self._device = device
        self._marker = torch.zeros(1, device=device)
        self._prof = None
        self.offset = 0.0  # device clock - host wall clock, seconds
        self.events: List[DeviceEvent] = []

    def start(self) -> None:
        torch = self._torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self._device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self._device)
        self._marker_host = time.time()
        self._marker.fill_(1.0)
        torch.cuda.synchronize(self._device)

    def stop(self) -> None:
        torch = self._torch
        torch.cuda.synchronize(self._device)
        t0 = time.perf_counter()
        self._prof.stop()
        self.stop_s = time.perf_counter() - t0
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = _ns(e, "start") * 1e-9
            raw.append((start, start + _ns(e, "duration") * 1e-9, e.name()))
        self._prof = None
        raw.sort()
        # the marker ran first on the idle card, a few microseconds
        # after its launch
        marks = [i for i, r in enumerate(raw) if "fill" in r[2].lower()] or [0]
        if raw:
            mark = raw.pop(marks[0])
            self.offset = mark[0] - self._marker_host
        self.events = [DeviceEvent(n, s - self.offset, t - self.offset) for s, t, n in raw]
        self.read_s = time.perf_counter() - t0 - self.stop_s


def _ns(event, what: str) -> int:
    """A kineto event's start or duration in nanoseconds (older torch
    builds give microseconds)."""
    if hasattr(event, f"{what}_ns"):
        return getattr(event, f"{what}_ns")()
    return int(getattr(event, f"{what}_us")() * 1000)


def busy_intervals(events: List[DeviceEvent], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    spans = sorted((max(e.start, lo), min(e.end, hi)) for e in events if e.end > lo and e.start < hi)
    merged: List[list] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    gaps, at = [], lo
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    return gaps


class LaunchRecorder:
    """Replaces each wrapper of guard_tpu_torch.kernels with one that
    records (wrapper, bytes) when the wrapper counted a launch."""

    def __init__(self):
        self.launches: List[Tuple[str, int]] = []
        self._saved: Dict[str, object] = {}

    def __enter__(self):
        from guard_tpu_torch import kernels as K

        for name, nbytes in BYTES.items():
            original = getattr(K, name)
            self._saved[name] = original
            setattr(K, name, self._wrap(K, name, original, nbytes))
        return self

    def _wrap(self, K, name, original, nbytes):
        @functools.wraps(original)
        def call(*args, **kwargs):
            before = K.LAUNCHES[name]
            out = original(*args, **kwargs)
            if K.LAUNCHES[name] != before:
                self.launches.append((name, nbytes(*args, **kwargs)))
            return out

        return call

    def __exit__(self, *exc):
        from guard_tpu_torch import kernels as K

        for name, original in self._saved.items():
            setattr(K, name, original)
        return False


class CallTimer:
    """Host seconds spent inside `owner.attr` (a method), summed."""

    def __init__(self, owner, attr: str):
        self.owner, self.attr = owner, attr
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        self._original = getattr(self.owner, self.attr)
        original = self._original

        @functools.wraps(original)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self._original)
        return False


@dataclass
class Span:
    name: str
    start: float  # host wall clock
    end: float
    lane: str


@dataclass
class SpanTimeline:
    """The program's telemetry spans recorded during the window (span
    tracing on), on the host's wall clock. Worker lanes are left out:
    the card waits on the main thread."""

    spans: List[Span] = field(default_factory=list)

    def start(self) -> None:
        from guard_tpu_torch.utils import telemetry

        telemetry.enable()
        telemetry.reset_trace()
        self._epoch = time.time()

    def stop(self) -> None:
        from guard_tpu_torch.utils import telemetry

        lanes = {}
        events = telemetry.trace_events()
        telemetry.disable()
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "thread_name":
                lanes[e["tid"]] = e["args"]["name"]
        for e in events:
            if e.get("ph") != "X":
                continue
            lane = lanes.get(e["tid"], "")
            if lane.startswith("worker"):
                continue
            start = self._epoch + e["ts"] * 1e-6
            self.spans.append(Span(e["name"], start, start + e["dur"] * 1e-6, lane))

    def segments(self) -> List[Tuple[float, float, str]]:
        """(start, end, innermost open span) over the spans' extent, in
        time order."""
        bounds = sorted({t for s in self.spans for t in (s.start, s.end)})
        by_start = sorted(self.spans, key=lambda s: s.start)
        out, active, k = [], [], 0
        for lo, hi in zip(bounds, bounds[1:]):
            active = [s for s in active if s.end > lo]
            while k < len(by_start) and by_start[k].start <= lo:
                if by_start[k].end > lo:
                    active.append(by_start[k])
                k += 1
            if active:
                inner = min(active, key=lambda s: s.end - s.start)
                out.append((lo, hi, inner.name))
        return out

    def attribute(self, gaps: List[Tuple[float, float]]) -> Dict[str, float]:
        """Seconds of the gaps by the innermost span open on the host,
        `outside_spans` where none was."""
        out: Dict[str, float] = {}
        segs = self.segments()
        k = 0
        for lo, hi in gaps:
            at = lo
            while k < len(segs) and segs[k][1] <= lo:
                k += 1
            j = k
            while at < hi:
                if j < len(segs) and segs[j][0] < hi:
                    s0, s1, name = segs[j]
                    if s0 > at:
                        out["outside_spans"] = out.get("outside_spans", 0.0) + min(s0, hi) - at
                        at = min(s0, hi)
                        continue
                    end = min(s1, hi)
                    if end > at:
                        out[name] = out.get(name, 0.0) + end - at
                        at = end
                    j += 1
                else:
                    out["outside_spans"] = out.get("outside_spans", 0.0) + hi - at
                    at = hi
        return out
