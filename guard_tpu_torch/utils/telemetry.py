"""The telemetry plane of the port: the metrics registry and the span
tracer.

The port's copy of guard_tpu/utils/telemetry.py (imports rewritten,
names and snapshot schema kept, so one checker and one trace viewer
read both packages):

**MetricsRegistry** (`REGISTRY`, process-global) — counters, gauges
and per-stage duration histograms with fixed log2 buckets. The port's
counter dicts are registered as named counter groups (`counter_group`)
by the modules that own them — `plan_cache` (ops/plan.py), `dispatch`
and `efficiency` (parallel/device.py), `rim` (ops/backend.py),
`analysis` (analysis/__init__.py), `fault` (utils/faults.py, an
`EventedCounters`) and `result_cache` (cache/results.py); the dict
objects stay the mutation surface (every `+= 1` site keeps working)
and the registry becomes the read/reset/snapshot authority.

**Spans** — `span(name, attrs)` is a nestable context manager around
each host stage of the card's path (rule parse, lowering, pack
compile, plan load/save, relocation, encode, dispatch, collect, rim
reduce, report, oracle reruns, result-cache lookups and stores).
Disabled spans cost ONE branch and allocate nothing (`span()` returns
a shared no-op singleton); span ids come from a monotonic per-process
sequence — not wall clock — so ordering is deterministic. Spans
recorded inside spawned ingest workers are shipped back with the shard
payload (`parallel/ingest._validate_shard_job`) and re-anchored here
onto per-worker lanes. Completed spans feed per-stage duration
histograms and count/total roll-ups in the registry. On the card a
`collect` span closes after the device-to-host copy, so the trace
separates host work from waiting on the card.

The port adds spans the JAX package does not have (`STAGE_LANES`).
Under every dispatch and collect of `parallel/device.py`:
`columnarize` (the batch's columns and literals on the host),
`h2d_copy` (their copy to the device) and `walk_enqueue` (the walk's
torch ops and kernel launches, K3's or K7's included) on the
`dispatch` lane, and `device_wait` (the wait on the walk and the
copies back) on the `collect` lane. Over the sweep
(`commands/sweep.py`): the root `sweep` around the whole command,
`sweep_scan` (the directory's listing, the manifest's read, the
chunks' signatures), `chunk_fold` (a chunk's tally, record, journal
append and manifest line) and `journal_close` on `main`, and
`ingest_wait` (the main thread waiting on an ingest worker's chunk,
the interval `pipeline.ingest_stall_seconds` counts) on `ingest`.

**One span clock** — a span's start and length both come from
`time.perf_counter`. `enable()` / `reset_trace()` read the wall clock
and that clock once, together (`_EPOCH`, `_EPOCH_PC`); a span's `ts`
is its start less `_EPOCH_PC`, so `_EPOCH + ts` is the wall time it
opened, and a step of the wall clock during a trace shifts no span
against another. Worker spans keep the wall starts their process
read.

**Export faces** — `write_trace(path)` emits Chrome `trace_event` JSON
(open in Perfetto or chrome://tracing: one lane per pipeline stage
plus one per ingest worker); `write_metrics(path)` /
`metrics_snapshot()` emit a schema-versioned snapshot of every counter
group, gauge, histogram and span roll-up (validated by
`tools/check_metrics_schema.py`).

Failure-plane faithfulness: `EventedCounters` (the FAULT_COUNTERS
dict class) turns every fault/recovery counter increment into an
instant trace event when tracing is on, and arms the flight recorder,
an always-on ring of the last spans and events that an abnormal exit
dumps (`flightrec_on_exit`).

This module imports nothing from the rest of guard_tpu_torch, so every
module (including `utils.faults`) can import it without cycles.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

#: metrics-snapshot schema version (tools/check_metrics_schema.py
#: validates against this; bump on breaking snapshot-shape changes).
#: v2: the `efficiency` counter/gauge group (padding waste, pack slot
#: occupancy, transfer bytes) joined the snapshot contract.
#: v3: per-doc-shard mesh gauges (`efficiency.shard_{s}.doc_fill` /
#: `.h2d` / `.d2h`), the `device_to_host_bytes_trimmed` efficiency
#: counter, the shard-prefetch pipeline counters, and the serve
#: `coalesce_window_adaptive` counter (2-D mesh plane + adaptive
#: coalesce window).
#: v4: the `result_cache` counter group (incremental validation plane:
#: per-doc hit/miss/store/bytes counters, delta_docs gauges, and the
#: cache_lookup/cache_store spans) joined the snapshot contract.
#: v5: the `analysis` counter group (static analysis plane:
#: invariants_checked / violations / lint_findings /
#: signatures_extracted), the verify_plan / lint spans, and the
#: plan_cache corrupt-cause counters (corrupt_unreadable /
#: corrupt_version_mismatch / corrupt_verify) joined the contract.
#: v6: the `admission` counter group (serving front door: per-tenant
#: quota admissions/rejections, SLO circuit-breaker trips/probes/
#: closes, overload sheds, streaming follow-mode docs/batches) and
#: the breaker-state / admission-inflight gauges joined the contract.
#: v7: the `resume` counter group (durability plane: journaled /
#: replayed chunks, stale-journal cold starts, torn tail records,
#: journal store degradations, drained sessions) and the `gc` counter
#: group (store hygiene: gc runs, evicted files/bytes, reaped orphan
#: tmps) joined the contract.
SCHEMA_VERSION = 7

# fixed log2 histogram buckets: bucket i holds durations in
# [2^(LOG2_LO+i-1), 2^(LOG2_LO+i)) seconds — ~1µs to ~128s, plus an
# underflow bucket at index 0 and an overflow bucket at the end.
LOG2_LO = -20
LOG2_HI = 7
_N_BUCKETS = LOG2_HI - LOG2_LO + 2


def _bucket_index(seconds: float) -> int:
    if seconds <= 0:
        return 0
    # frexp: seconds = m * 2^e with 0.5 <= m < 1, so seconds lives in
    # [2^(e-1), 2^e) — exactly the log2 bucket boundaries
    _m, e = math.frexp(seconds)
    return min(max(e - LOG2_LO, 0), _N_BUCKETS - 1)


def bucket_label(i: int) -> str:
    """Human-readable upper bound of bucket i (snapshot keys)."""
    if i >= _N_BUCKETS - 1:
        return "inf"
    return f"le_2^{LOG2_LO + i}s"


class Histogram:
    """Fixed log2-bucket duration histogram with count/total/min/max
    and bucket-resolution quantiles (p50/p99 for the serve latency
    story)."""

    __slots__ = ("name", "persistent", "counts", "count", "total",
                 "min", "max")

    def __init__(self, name: str, persistent: bool = False):
        self.name = name
        # persistent histograms survive reset_all_stats (serve resets
        # engine counters between requests but the per-request latency
        # distribution must accumulate across the session)
        self.persistent = persistent
        self._zero()

    def _zero(self) -> None:
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, seconds: float) -> None:
        self.counts[_bucket_index(seconds)] += 1
        self.count += 1
        self.total += seconds
        if self.min is None or seconds < self.min:
            self.min = seconds
        if self.max is None or seconds > self.max:
            self.max = seconds

    def quantile(self, q: float) -> Optional[float]:
        """Upper bucket bound at quantile q (bucket resolution — a
        factor-of-2 answer, which is what a latency SLO check needs).
        Edges: an empty histogram has no quantiles (None); q <= 0 is
        the observed minimum, not the first nonempty bucket's bound;
        and the answer never exceeds the observed maximum (a single
        observation reports p50 == p99 == that value instead of its
        bucket ceiling)."""
        if self.count == 0:
            return None
        target = q * self.count
        if target <= 0:
            return self.min
        seen = 0
        for i, n in enumerate(self.counts):
            seen += n
            if seen >= target:
                if i >= _N_BUCKETS - 1:
                    return self.max
                return min(2.0 ** (LOG2_LO + i), self.max)
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "total_seconds": self.total,
            "min_seconds": self.min,
            "max_seconds": self.max,
            "p50_seconds": self.quantile(0.50),
            "p99_seconds": self.quantile(0.99),
            "buckets": {
                bucket_label(i): n
                for i, n in enumerate(self.counts) if n
            },
        }


class EventedCounters(dict):
    """A counter dict whose increments become instant trace events
    when tracing is enabled (used for FAULT_COUNTERS: every injected
    fault, retry, pool restart, quarantine and ladder fallback lands
    in the trace with zero per-site changes). Plain-dict semantics
    otherwise — existing `d[k] += 1` sites are untouched."""

    __slots__ = ("group",)

    def __init__(self, group: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def __setitem__(self, key, value):
        if _ON or _FR_ON:
            old = self.get(key, 0)
            if isinstance(value, (int, float)) and value > old:
                event(f"{self.group}.{key}", {"value": value})
        super().__setitem__(key, value)


class MetricsRegistry:
    """Process-global registry of counter groups, gauges, duration
    histograms and span roll-ups. One `reset()` clears every
    observability plane atomically (under one lock) — the counter-
    reset footgun killer behind `backend.reset_all_stats()`."""

    def __init__(self):
        self._lock = threading.RLock()
        self._groups: "OrderedDict[str, dict]" = OrderedDict()
        self._group_zeros: Dict[str, dict] = {}
        self._group_resets: Dict[str, object] = {}
        self._gauges: "OrderedDict[str, float]" = OrderedDict()
        self._hists: "OrderedDict[str, Histogram]" = OrderedDict()
        # span roll-ups: name -> [count, total_seconds]
        self._spans: "OrderedDict[str, list]" = OrderedDict()

    # -- counter groups (the absorbed module dicts) -------------------
    def counter_group(self, name: str, counters: dict, extra_reset=None) -> dict:
        """Adopt `counters` as group `name` and return it. The dict
        object remains the owning module's mutation surface; initial
        values are snapshotted so reset restores them bit-compatibly
        (ints stay ints, float accumulators stay floats). `extra_reset`
        runs after each reset of the group (state kept beside it)."""
        with self._lock:
            self._groups[name] = counters
            self._group_zeros[name] = dict(counters)
            if extra_reset is not None:
                self._group_resets[name] = extra_reset
        return counters

    def group_stats(self, name: str) -> dict:
        return dict(self._groups[name])

    def reset_group(self, name: str) -> None:
        with self._lock:
            g = self._groups[name]
            for k, v in self._group_zeros[name].items():
                g[k] = v
            extra = self._group_resets.get(name)
            if extra is not None:
                extra()

    # -- gauges / histograms ------------------------------------------
    def set_gauge(self, name: str, value) -> None:
        self._gauges[name] = value

    def histogram(self, name: str, persistent: bool = False) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.get(name)
                if h is None:
                    h = self._hists[name] = Histogram(name, persistent)
        return h

    # -- span roll-ups ------------------------------------------------
    def observe_span(self, name: str, seconds: float) -> None:
        roll = self._spans.get(name)
        if roll is None:
            with self._lock:
                roll = self._spans.setdefault(name, [0, 0.0])
        roll[0] += 1
        roll[1] += seconds
        self.histogram(f"stage.{name}").observe(seconds)

    def span_rollups(self) -> Dict[str, dict]:
        return {
            name: {"count": c, "total_seconds": s}
            for name, (c, s) in self._spans.items()
        }

    # -- snapshot / reset ---------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "schema_version": SCHEMA_VERSION,
                "counters": {
                    name: dict(g) for name, g in self._groups.items()
                },
                "gauges": dict(self._gauges),
                "histograms": {
                    name: h.snapshot() for name, h in self._hists.items()
                },
                "spans": self.span_rollups(),
            }

    def reset(self, include_persistent: bool = False) -> None:
        """Reset every group, gauge, histogram and span roll-up under
        one lock. Persistent histograms (serve request latency) survive
        unless `include_persistent`."""
        with self._lock:
            for name in self._groups:
                self.reset_group(name)
            self._gauges.clear()
            for name in list(self._hists):
                h = self._hists[name]
                if h.persistent and not include_persistent:
                    continue
                h._zero()
            self._spans.clear()


#: the process-global registry every subsystem registers with
REGISTRY = MetricsRegistry()

#: The JAX package's serving, front-door, durability and store-hygiene
#: groups (`serve`, `admission`, `resume`, `gc`) register here, as
#: there, so every snapshot of the port carries the schema's groups with
#: the same keys. `serve` (commands/serve.py, serve/) counts `serve` and
#: `admission`, `sweep` (commands/sweep.py) counts `resume` and
#: `admission.follow_*`, and `gc` (commands/gc.py) counts `gc`.
SERVE_COUNTERS = REGISTRY.counter_group("serve", EventedCounters("serve", {
    "requests": 0,
    "coalesce_eligible": 0,
    "coalesce_bypass": 0,
    "coalesced_batches": 0,
    "coalesced_requests": 0,
    "singleton_batches": 0,
    "solo_fallbacks": 0,
    "isolation_refires": 0,
    "request_timeouts": 0,
    "abandoned_threads": 0,
    # adaptive coalesce window: batches dispatched immediately because
    # the sole queued request found the admission queue empty — the
    # formation wait would have bought pure latency (c=1 parity with
    # coalesce-off)
    "coalesce_window_adaptive": 0,
}))

ADMISSION_COUNTERS = REGISTRY.counter_group(
    "admission", EventedCounters("admission", {
        "admitted": 0,
        "rejected_rate": 0,
        "rejected_inflight": 0,
        "rejected_queue_full": 0,
        "rejected_body_size": 0,
        "shed_solo": 0,
        "breaker_trips": 0,
        "breaker_probes": 0,
        "breaker_closes": 0,
        "follow_docs": 0,
        "follow_batches": 0,
    })
)

RESUME_COUNTERS = REGISTRY.counter_group("resume", EventedCounters(
    "resume", {
        "chunks_journaled": 0,
        "chunks_replayed": 0,
        "runs_resumed": 0,
        "stale_cold_starts": 0,
        "torn_records_dropped": 0,
        "journal_degraded": 0,
        "drained_sessions": 0,
    }
))

#: the sweep's chunk pipeline (commands/sweep.py), the JAX package's
#: `pipeline` group (guard_tpu/parallel/mesh.py:162): chunks the ingest
#: workers encoded, those encoded while the previous chunk's device work
#: was in flight, the deepest prefetch queue, and the seconds the
#: dispatch stage waited on ingest, read and encoded, and the doc shards
#: the 2-D mesh's prefetch thread cut ahead of the dispatch loop with
#: the seconds that loop waited on it (parallel/ingest.ShardPrefetcher;
#: 0 with one card or one shard).
PIPELINE_COUNTERS = REGISTRY.counter_group("pipeline", {
    "chunks_prefetched": 0,
    "encode_dispatch_overlap": 0,
    "max_inflight_chunks": 0,
    "ingest_stall_seconds": 0.0,
    "read_parse_seconds": 0.0,
    "encode_seconds": 0.0,
    "shards_prefetched": 0,
    "shard_prefetch_stall_seconds": 0.0,
})

GC_COUNTERS = REGISTRY.counter_group("gc", EventedCounters("gc", {
    "runs": 0,
    "files_evicted": 0,
    "bytes_evicted": 0,
    "orphan_tmps_reaped": 0,
    "evict_errors": 0,
}))


# ---------------------------------------------------------------- spans

#: single-branch disabled check: span()/event() read this module
#: global and return the shared no-op before touching anything else
_ON = False


def _flightrec_env() -> bool:
    return os.environ.get("GUARD_TPU_FLIGHT_RECORDER", "1").lower() not in (
        "0", "false", "no", "off",
    )


#: flight-recorder switch, resolved from GUARD_TPU_FLIGHT_RECORDER at
#: import (default ON — the recorder's whole point is being armed when
#: nobody asked for --trace-out). flightrec_refresh() re-reads the env
#: for tests and long-lived embedders.
_FR_ON = _flightrec_env()

#: monotonic per-process span-id sequence (deterministic ordering —
#: ids never come from wall clock)
_SEQ = itertools.count(1)

_TRACE: List[dict] = []  # finished span records
_EVENTS: List[dict] = []  # instant events (fault/fallback annotations)
_EPOCH = 0.0  # wall-clock anchor for trace timestamps (time.time)
_EPOCH_PC = 0.0  # the span clock (time.perf_counter) read with _EPOCH
#: wall time less the span clock: the flight recorder's wall times
_PC_TO_WALL = time.time() - time.perf_counter()
_TLS = threading.local()  # per-thread span stack (nesting/parents)
_TRACE_LOCK = threading.Lock()

#: span name -> trace lane (Chrome tid). One lane per pipeline stage;
#: names not listed land on "main"; worker spans get "worker-<pid>".
STAGE_LANES = {
    "rule_parse": "rules",
    "lower_compile": "rules",
    "pack_compile": "rules",
    "load_plan": "rules",
    "save_plan": "rules",
    "relocate": "rules",
    "read_parse": "ingest",
    "encode": "ingest",
    "dispatch": "dispatch",
    "collect": "collect",
    "rim_reduce": "rim",
    "report": "rim",
    "oracle": "oracle",
    "serve_request": "serve",
    # the port's own: the device phase of every dispatch and collect
    # (parallel/device.py) and the sweep's untraced work
    # (commands/sweep.py)
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

#: lane display order in the trace viewer (pipeline order)
_LANE_ORDER = (
    "main", "rules", "ingest", "dispatch", "collect", "rim",
    "oracle", "serve",
)


def enabled() -> bool:
    return _ON


def _anchor() -> None:
    """Read the wall clock and the span clock together: the one place
    a span's monotonic time is mapped onto the wall clock."""
    global _EPOCH, _EPOCH_PC, _PC_TO_WALL
    _EPOCH = time.time()
    _EPOCH_PC = time.perf_counter()
    _PC_TO_WALL = _EPOCH - _EPOCH_PC


def enable() -> None:
    """Turn span tracing on (idempotent). The wall-clock epoch anchors
    trace timestamps: a span's `ts` is its monotonic start less the
    span clock's reading at the epoch, so `_EPOCH + ts` is the wall
    time it opened. Worker spans carry absolute wall times so both
    sides of a process boundary land on one timeline."""
    global _ON
    if not _ON:
        if _EPOCH == 0.0:
            _anchor()
        _ON = True


def disable() -> None:
    global _ON
    _ON = False


def reset_trace() -> None:
    """Drop the trace buffers and epoch (tests; fresh sessions)."""
    global _EPOCH
    with _TRACE_LOCK:
        _TRACE.clear()
        _EVENTS.clear()
        if _ON:
            _anchor()
        else:
            _EPOCH = 0.0
    _TLS.stack = []


class _NoopSpan:
    """The shared disabled-path singleton: `span()` returns this
    without allocating, entering/exiting/annotating it is free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "sid", "parent", "t0")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.sid = next(_SEQ)
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self.parent = stack[-1] if stack else 0
        stack.append(self.sid)
        self.t0 = time.perf_counter()
        return self

    def set(self, key, value):
        """Annotate the live span (e.g. error_class on failure)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __exit__(self, exc_type, exc, _tb):
        dur = time.perf_counter() - self.t0
        stack = getattr(_TLS, "stack", None)
        if stack:
            stack.pop()
        if exc is not None:
            self.set("error_class", type(exc).__name__)
        REGISTRY.observe_span(self.name, dur)
        rec = {
            "sid": self.sid,
            "parent": self.parent,
            "name": self.name,
            "lane": STAGE_LANES.get(self.name, "main"),
            "ts": self.t0 - _EPOCH_PC,
            "dur": dur,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        with _TRACE_LOCK:
            _TRACE.append(rec)
        if _FR_ON:
            _FLIGHTREC.record(
                "X", self.name, STAGE_LANES.get(self.name, "main"),
                self.t0 + _PC_TO_WALL, dur, self.attrs,
            )
        return False


# -------------------------------------------------- flight recorder

class _FlightRecorder:
    """Always-on fixed-size ring of the most recent spans and instant
    events: slots are preallocated 7-element lists mutated in place
    (no per-record allocation), so the recorder can stay armed in
    production at negligible cost and an abnormal exit can dump the
    last ~256 things the process did — without --trace-out having been
    passed. GUARD_TPU_FLIGHT_RECORDER=0 is the escape hatch."""

    __slots__ = ("capacity", "slots", "head", "written", "fault_seen",
                 "lock")

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        # slot layout: [seq, ph, name, lane, wall_ts, dur, attrs]
        self.slots = [[0, "", "", "", 0.0, 0.0, None]
                      for _ in range(capacity)]
        self.lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.head = 0
        self.written = 0
        self.fault_seen = False

    def record(self, ph: str, name: str, lane: str, wall_ts: float,
               dur: float, attrs: Optional[dict]) -> None:
        with self.lock:
            slot = self.slots[self.head]
            slot[0] = self.written + 1
            slot[1] = ph
            slot[2] = name
            slot[3] = lane
            slot[4] = wall_ts
            slot[5] = dur
            slot[6] = attrs
            self.head = (self.head + 1) % self.capacity
            self.written += 1

    def snapshot(self) -> List[list]:
        """Copies of the live slots, oldest first (seq order)."""
        with self.lock:
            if self.written <= self.capacity:
                ordered = self.slots[: self.written]
            else:
                ordered = self.slots[self.head:] + self.slots[: self.head]
            return [list(s) for s in ordered]


_FLIGHTREC = _FlightRecorder(
    int(os.environ.get("GUARD_TPU_FLIGHTREC_SLOTS", "256") or 256)
)
_FR_DUMP_SEQ = itertools.count(1)


def flightrec_enabled() -> bool:
    return _FR_ON


def flightrec_refresh() -> bool:
    """Re-read GUARD_TPU_FLIGHT_RECORDER (tests; embedders that flip
    the env after import)."""
    global _FR_ON
    _FR_ON = _flightrec_env()
    return _FR_ON


def flightrec_reset() -> None:
    """Drop the ring contents and the fault-seen latch (tests; fresh
    serve sessions)."""
    with _FLIGHTREC.lock:
        _FLIGHTREC._zero()


def flightrec_mark_fault(name: str, attrs: Optional[dict] = None) -> None:
    """Record a fault-class instant event and arm the abnormal-exit
    dump (serve request timeouts/errors use this; fault.* counter
    events arm it automatically through EventedCounters)."""
    if _FR_ON:
        _FLIGHTREC.fault_seen = True
    event(name, attrs)


def flightrec_events() -> List[dict]:
    """Chrome trace_event objects for the ring contents, oldest first.
    Timestamps are normalized to the oldest retained record so the
    dump opens at t=0 in a trace viewer."""
    slots = _FLIGHTREC.snapshot()
    t0 = min((s[4] for s in slots), default=0.0)
    lanes: "OrderedDict[str, int]" = OrderedDict()

    def tid(lane: str) -> int:
        if lane not in lanes:
            lanes[lane] = len(lanes) + 1
        return lanes[lane]

    out = []
    for seq, ph, name, lane, wall_ts, dur, attrs in slots:
        args = dict(attrs or {})
        args["seq"] = seq
        ev = {
            "name": name,
            "cat": lane,
            "ph": ph,
            "ts": round(max(wall_ts - t0, 0.0) * 1e6, 3),
            "pid": 1,
            "tid": tid(lane),
            "args": args,
        }
        if ph == "X":
            ev["dur"] = round(max(dur, 0.0) * 1e6, 3)
        else:
            ev["s"] = "g"
        out.append(ev)
    meta = [{
        "name": "process_name", "ph": "M", "pid": 1,
        "args": {"name": "guard-tpu-torch flight recorder"},
    }]
    for lane, t in lanes.items():
        meta.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": t,
            "args": {"name": lane},
        })
    return meta + out


def flightrec_dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Write the flight-recorder forensics document: the ring as
    Chrome-trace-compatible `traceEvents` plus a full metrics snapshot.
    Returns the written path, or None when the recorder is disabled.
    Destination: `path`, else flightrec-<pid>-<n>.json under
    GUARD_TPU_FLIGHTREC_DIR (default: ~/.cache/guard_tpu_torch/flightrec —
    NOT the working directory, so abnormal-exit dumps never litter
    whatever repo the CLI happened to run from)."""
    if not _FR_ON:
        return None
    if path is None:
        d = os.environ.get("GUARD_TPU_FLIGHTREC_DIR") or os.path.join(
            os.path.expanduser("~"), ".cache", "guard_tpu_torch", "flightrec"
        )
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flightrec-{os.getpid()}-{next(_FR_DUMP_SEQ)}.json"
        )
    doc = {
        "traceEvents": flightrec_events(),
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "guard-tpu-torch",
            "flight_recorder": True,
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "records_written": _FLIGHTREC.written,
            "ring_capacity": _FLIGHTREC.capacity,
        },
        "metrics": metrics_snapshot(),
    }
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


def flightrec_on_exit(exit_code: Optional[int]) -> Optional[str]:
    """Session epilogue hook (cli.run): dump when the run ended
    abnormally — exit code 5 (hard errors, --max-doc-failures trips),
    an unhandled exception (exit_code None), a sweep's graceful drain
    (the SIGTERM/SIGINT latch's exit code, utils/journal.DRAIN_EXIT_CODE)
    or fault activity latched during an otherwise-clean run
    (dispatch-ladder fallbacks). Returns the dump path or None."""
    if not _FR_ON:
        return None
    if exit_code == 5:
        return flightrec_dump("exit_code_5")
    if exit_code is None:
        return flightrec_dump("unhandled_exception")
    from .journal import DRAIN_EXIT_CODE  # lazy: journal imports us

    if exit_code == DRAIN_EXIT_CODE:
        return flightrec_dump("drain")
    if _FLIGHTREC.fault_seen:
        return flightrec_dump("fault_activity")
    return None


class _FrSpan:
    """The flight-recorder-only span: when tracing is off but the
    recorder is armed, span() returns this instead of the no-op — its
    exit writes one ring slot and one registry roll-up (so the dump's
    metrics section has the stage story), nothing else."""

    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def set(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __exit__(self, exc_type, exc, _tb):
        dur = time.perf_counter() - self.t0
        if exc is not None:
            self.set("error_class", type(exc).__name__)
        REGISTRY.observe_span(self.name, dur)
        _FLIGHTREC.record(
            "X", self.name, STAGE_LANES.get(self.name, "main"),
            self.t0 + _PC_TO_WALL, dur, self.attrs,
        )
        return False


def span(name: str, attrs: Optional[dict] = None):
    """A pipeline-stage span. Fully disabled: two branches, no
    allocation (returns the shared no-op singleton). Tracing enabled:
    a nestable context manager whose completion feeds the registry
    roll-ups and the trace buffer. Tracing off but flight recorder
    armed: a slim span whose completion writes one ring slot."""
    if _ON:
        return _Span(name, attrs)
    if _FR_ON:
        return _FrSpan(name, attrs)
    return _NOOP


def span_begin(name: str, attrs: Optional[dict] = None):
    """Open a span around a large inline block where a `with` would
    force re-indenting the whole region; pair with `span_end`. Same
    disabled-path cost as span()."""
    sp = span(name, attrs)
    if sp is not _NOOP:
        sp.__enter__()
    return sp


def span_end(sp) -> None:
    """Close a span opened with span_begin (exception annotation is
    the caller's job via sp.set — an abort skips the close entirely,
    leaving the span out of the trace rather than lying about it)."""
    sp.__exit__(None, None, None)


def event(name: str, attrs: Optional[dict] = None) -> None:
    """Instant trace event (fault firings, fallbacks, pool restarts).
    No-op when both tracing and the flight recorder are off. A fault.*
    event latches the recorder's fault-seen flag, arming the
    abnormal-exit dump."""
    if not _ON and not _FR_ON:
        return
    now = time.perf_counter()
    if _FR_ON:
        if name.startswith("fault."):
            _FLIGHTREC.fault_seen = True
        _FLIGHTREC.record("i", name, "events", now + _PC_TO_WALL, 0.0, attrs)
    if not _ON:
        return
    stack = getattr(_TLS, "stack", None)
    rec = {
        "sid": next(_SEQ),
        "parent": stack[-1] if stack else 0,
        "name": name,
        "lane": "events",
        "ts": now - _EPOCH_PC,
    }
    if attrs:
        rec["attrs"] = attrs
    with _TRACE_LOCK:
        _EVENTS.append(rec)


# -------------------------------------------- worker span round-trip

def worker_spans(stage_times: List[tuple]) -> List[dict]:
    """Build the picklable span records an ingest worker ships back
    with its chunk payload: [(name, wall_start, duration_seconds)].
    Cheap enough to produce unconditionally — the parent drops them
    when tracing is off."""
    import os

    return [
        {"name": name, "wall0": wall0, "dur": dur, "pid": os.getpid()}
        for name, wall0, dur in stage_times
    ]


def ingest_worker_spans(spans, chunk: Optional[int] = None) -> None:
    """Re-anchor worker-shipped span records onto this process's
    timeline: fresh ids from the parent's monotonic sequence, a
    per-worker lane, wall-clock ts (shared across processes, so the
    encode/dispatch overlap is genuinely visible in the trace)."""
    if not _ON or not spans:
        return
    with _TRACE_LOCK:
        for s in spans:
            rec = {
                "sid": next(_SEQ),
                "parent": 0,
                "name": s["name"],
                "lane": f"worker-{s.get('pid', 0)}",
                "ts": s["wall0"] - _EPOCH,
                "dur": s["dur"],
            }
            attrs = {"worker": True}
            if chunk is not None:
                attrs["chunk"] = chunk
            rec["attrs"] = attrs
            _TRACE.append(rec)
            REGISTRY.observe_span(s["name"], s["dur"])


# ------------------------------------------------------- export faces

def metrics_snapshot() -> dict:
    """The schema-versioned metrics snapshot: every counter group,
    gauge, histogram and span roll-up (`--metrics-out`, the flight
    recorder's dump)."""
    return REGISTRY.snapshot()


def write_metrics(path: str) -> None:
    # NO sort_keys: histogram bucket labels ("le_2^-7s") do not sort
    # lexically, and the snapshot's insertion order (ascending bucket
    # exponents) is part of the schema contract —
    # check_metrics_schema._check_bucket_labels enforces it
    with open(path, "w") as f:
        json.dump(metrics_snapshot(), f, indent=1)
        f.write("\n")


def trace_events() -> List[dict]:
    """Chrome trace_event objects for the current buffers (the
    `traceEvents` list of write_trace, exposed for tests/smokes)."""
    lanes: "OrderedDict[str, int]" = OrderedDict()

    def tid(lane: str) -> int:
        if lane not in lanes:
            lanes[lane] = len(lanes) + 1
        return lanes[lane]

    with _TRACE_LOCK:
        spans = sorted(_TRACE, key=lambda s: (s["ts"], s["sid"]))
        events = sorted(_EVENTS, key=lambda e: (e["ts"], e["sid"]))
    out = []
    for s in spans:
        args = dict(s.get("attrs") or {})
        args["sid"] = s["sid"]
        if s["parent"]:
            args["parent"] = s["parent"]
        out.append({
            "name": s["name"],
            "cat": s["lane"],
            "ph": "X",
            "ts": round(max(s["ts"], 0.0) * 1e6, 3),
            "dur": round(max(s["dur"], 0.0) * 1e6, 3),
            "pid": 1,
            "tid": tid(s["lane"]),
            "args": args,
        })
    for e in events:
        args = dict(e.get("attrs") or {})
        args["sid"] = e["sid"]
        out.append({
            "name": e["name"],
            "cat": "events",
            "ph": "i",
            "s": "g",
            "ts": round(max(e["ts"], 0.0) * 1e6, 3),
            "pid": 1,
            "tid": tid("events"),
            "args": args,
        })
    # metadata: stable lane names + pipeline-ordered sort
    meta = [{
        "name": "process_name", "ph": "M", "pid": 1,
        "args": {"name": "guard-tpu-torch"},
    }]
    order = {lane: i for i, lane in enumerate(_LANE_ORDER)}
    for lane, t in lanes.items():
        meta.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": t,
            "args": {"name": lane},
        })
        meta.append({
            "name": "thread_sort_index", "ph": "M", "pid": 1, "tid": t,
            "args": {"sort_index": order.get(lane, 100 + t)},
        })
    return meta + out


def write_trace(path: str) -> None:
    """Chrome trace_event JSON (load in Perfetto / chrome://tracing):
    one lane per pipeline stage plus per-worker lanes; fault events on
    an instant-event lane."""
    doc = {
        "traceEvents": trace_events(),
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "guard-tpu-torch",
            "schema_version": SCHEMA_VERSION,
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")


def reset_metrics() -> None:
    """Registry reset (counters/gauges/histograms/roll-ups). The trace
    buffer is an artifact log, not a stat — reset_trace() is separate
    so serve's between-request counter resets never eat the session
    trace."""
    REGISTRY.reset()
