"""Traffic discipline for the serving plane: the front door.

A copy of the JAX package's guard_tpu/serve/frontdoor.py (no device
code here). One hot tenant can fill the bounded admission queue of the
coalescing batcher (serve/batcher.py) for everyone, and a stalled
coalesce window has no escape to solo dispatch. This module is the
layer in front of the batcher:

* **Per-tenant admission quotas** (`AdmissionController`): a token
  bucket per tenant (`GUARD_TPU_TENANT_RATE` requests/sec, burst
  `GUARD_TPU_TENANT_BURST`) plus a per-tenant in-flight ceiling
  (`GUARD_TPU_TENANT_MAX_INFLIGHT`). Over-quota requests get a
  structured 429-class rejection (`QuotaExceeded`, mapped to HTTP 429
  by serve/server.py and to a `code: 5` + `error_class` JSONL envelope
  by commands/serve.py) — never a hang, never a silent drop. The
  tenant id comes from the request envelope (`"tenant"`), the HTTP
  header (`X-Guard-Tenant`), or the connection default
  (`GUARD_TPU_TENANT_DEFAULT`).

* **A latency-SLO circuit breaker** (`CircuitBreaker`): tracks
  per-digest formation+dispatch latency (the whole time a request
  spends inside `CoalescingBatcher.submit`) against
  `GUARD_TPU_SERVE_SLO_MS`. When the sliding-window p99 breaches the
  SLO — batch fill is stalling — or the admission queue saturates, the
  breaker OPENS and subsequent same-digest requests shed to immediate
  solo dispatch (`GUARD_TPU_SERVE_SHED=0` disables shedding: the
  queue-full path then answers a structured 429 instead). After
  `GUARD_TPU_BREAKER_COOLDOWN_MS` one HALF-OPEN probe rides the
  batcher; meeting the SLO re-CLOSES the breaker, missing it re-opens.
  States are observable as `breaker_state.<digest>` gauges (0 closed /
  1 open / 2 half-open) and every transition increments an
  `admission` EventedCounter — an instant trace event the flight
  recorder's ring captures.

Both state machines take an injectable `clock` (seconds, monotonic) so
the breaker/quota tests run on a deterministic clock — no wall-time in
assertions, same discipline as utils/faults.py.

Fault points (utils/faults.py, scoped to the front door): `admission`
fires inside the quota check, `shed` inside the breaker's solo-shed
path — chaos runs prove an injected front-door fault still answers
every request with a structured error.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from ..core.errors import GuardError
from ..utils import telemetry
from ..utils.faults import maybe_fail
from ..utils.telemetry import ADMISSION_COUNTERS

#: breaker states (gauge values: the snapshot face of the machine)
CLOSED, OPEN, HALF_OPEN = 0, 1, 2

_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


# -- rejection envelope --------------------------------------------------

class AdmissionRejected(GuardError):
    """Base of the structured 429-class rejections: the request was
    refused by traffic discipline, not by evaluation. Carries a retry
    hint the response envelope and the HTTP face both surface."""

    def __init__(self, msg: str, retry_after_ms: int = 1000):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class QuotaExceeded(AdmissionRejected):
    """A tenant exceeded its token-bucket rate or in-flight ceiling."""


class QueueFull(AdmissionRejected):
    """The bounded admission queue stayed full past the bounded wait
    (and shedding was disabled or unavailable)."""


class BodyTooLarge(GuardError):
    """An HTTP body or JSONL line exceeded GUARD_TPU_SERVE_MAX_BODY;
    the transport answers a structured 413."""


# -- env knobs (same try/except idiom as the rest of the repo) -----------

def default_tenant() -> str:
    """Connection-default tenant id (GUARD_TPU_TENANT_DEFAULT) for
    requests that carry no envelope field or header."""
    return os.environ.get("GUARD_TPU_TENANT_DEFAULT", "").strip() or "default"


def tenant_rate() -> float:
    """Token-bucket refill rate in requests/sec per tenant
    (GUARD_TPU_TENANT_RATE); 0 or unset = unlimited."""
    raw = os.environ.get("GUARD_TPU_TENANT_RATE", "").strip()
    try:
        return max(0.0, float(raw)) if raw else 0.0
    except ValueError:
        return 0.0


def tenant_burst() -> float:
    """Token-bucket capacity per tenant (GUARD_TPU_TENANT_BURST);
    defaults to the rate (>= 1) so a quiet tenant can always send at
    least one request instantly."""
    raw = os.environ.get("GUARD_TPU_TENANT_BURST", "").strip()
    try:
        if raw:
            return max(1.0, float(raw))
    except ValueError:
        pass
    return max(1.0, tenant_rate())


def tenant_max_inflight() -> int:
    """Per-tenant in-flight request ceiling
    (GUARD_TPU_TENANT_MAX_INFLIGHT); 0 or unset = unlimited."""
    raw = os.environ.get("GUARD_TPU_TENANT_MAX_INFLIGHT", "").strip()
    try:
        return max(0, int(raw)) if raw else 0
    except ValueError:
        return 0


def serve_slo_s() -> float:
    """Formation+dispatch latency SLO in seconds
    (GUARD_TPU_SERVE_SLO_MS); 0 or unset disables the breaker — the
    bit-parity default: with no SLO configured the serving path is
    byte-identical to the pre-front-door tier."""
    raw = os.environ.get("GUARD_TPU_SERVE_SLO_MS", "").strip()
    try:
        return max(0.0, float(raw)) / 1000.0 if raw else 0.0
    except ValueError:
        return 0.0


def breaker_cooldown_s() -> float:
    """OPEN -> HALF_OPEN cooldown (GUARD_TPU_BREAKER_COOLDOWN_MS,
    default 1000ms): how long the breaker sheds before probing."""
    raw = os.environ.get("GUARD_TPU_BREAKER_COOLDOWN_MS", "").strip()
    try:
        return max(0.0, float(raw)) / 1000.0 if raw else 1.0
    except ValueError:
        return 1.0


def breaker_min_samples() -> int:
    """Samples required before a p99 breach can trip the breaker
    (GUARD_TPU_BREAKER_MIN_SAMPLES, default 8) — one slow compile
    must not open the breaker on a cold digest. Queue saturation
    trips immediately regardless."""
    raw = os.environ.get("GUARD_TPU_BREAKER_MIN_SAMPLES", "").strip()
    try:
        return max(1, int(raw)) if raw else 8
    except ValueError:
        return 8


def shed_enabled() -> bool:
    """GUARD_TPU_SERVE_SHED=0 disables overload shedding (queue-full
    then answers a structured 429 instead of solo dispatch)."""
    return os.environ.get("GUARD_TPU_SERVE_SHED", "1") != "0"


def queue_wait_s() -> float:
    """Bounded wait for admission-queue space
    (GUARD_TPU_SERVE_QUEUE_WAIT_MS, default 100ms). The front door
    never blocks unboundedly: past this wait the request is shed or
    rejected 429, so a saturated queue cannot wedge the accept loop."""
    raw = os.environ.get("GUARD_TPU_SERVE_QUEUE_WAIT_MS", "").strip()
    try:
        return max(0.0, float(raw)) / 1000.0 if raw else 0.1
    except ValueError:
        return 0.1


def max_body_bytes() -> int:
    """Request body / JSONL line size cap in bytes
    (GUARD_TPU_SERVE_MAX_BODY, default 10 MiB); 0 disables the cap."""
    raw = os.environ.get("GUARD_TPU_SERVE_MAX_BODY", "").strip()
    try:
        return max(0, int(raw)) if raw else 10 * 1024 * 1024
    except ValueError:
        return 10 * 1024 * 1024


# -- per-tenant admission quotas -----------------------------------------

class _TokenBucket:
    """Classic token bucket on an injected clock: `rate` tokens/sec
    refill up to `burst`; `take()` consumes one or reports empty."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.stamp = now

    def take(self, now: float) -> bool:
        if now > self.stamp:
            self.tokens = min(
                self.burst, self.tokens + (now - self.stamp) * self.rate
            )
            self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Per-tenant token-bucket rate + in-flight ceiling over the
    serving plane's admission path. `admit(tenant)` either returns
    (counted in-flight until `release`) or raises QuotaExceeded — it
    NEVER blocks. Limits resolve from the env per controller (tests
    pass them explicitly); rate 0 / inflight 0 mean unlimited, which
    keeps the default serving path byte-identical."""

    def __init__(self, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 clock=time.monotonic):
        self.rate = tenant_rate() if rate is None else rate
        self.burst = tenant_burst() if burst is None else burst
        self.max_inflight = (
            tenant_max_inflight() if max_inflight is None else max_inflight
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._inflight: Dict[str, int] = {}

    def admit(self, tenant: str) -> None:
        # the failure plane's front-door leg: an injected admission
        # fault answers a structured error, never a hang
        maybe_fail("admission", key=tenant)
        with self._lock:
            now = self._clock()
            if self.max_inflight > 0:
                if self._inflight.get(tenant, 0) >= self.max_inflight:
                    ADMISSION_COUNTERS["rejected_inflight"] += 1
                    raise QuotaExceeded(
                        f"tenant {tenant!r} at max in-flight "
                        f"({self.max_inflight})",
                        retry_after_ms=100,
                    )
            if self.rate > 0:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = _TokenBucket(
                        self.rate, self.burst, now
                    )
                    telemetry.REGISTRY.set_gauge(
                        "admission_tenants", len(self._buckets)
                    )
                if not bucket.take(now):
                    ADMISSION_COUNTERS["rejected_rate"] += 1
                    raise QuotaExceeded(
                        f"tenant {tenant!r} over rate "
                        f"({self.rate:g} req/s, burst {self.burst:g})",
                        retry_after_ms=int(1000.0 / self.rate) or 1,
                    )
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            ADMISSION_COUNTERS["admitted"] += 1
            telemetry.REGISTRY.set_gauge(
                "admission_inflight", sum(self._inflight.values())
            )

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 1) - 1
            if n <= 0:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n
            telemetry.REGISTRY.set_gauge(
                "admission_inflight", sum(self._inflight.values())
            )


# -- latency-SLO circuit breaker -----------------------------------------

class _DigestState:
    __slots__ = ("state", "samples", "opened_at", "probing")

    def __init__(self):
        self.state = CLOSED
        # sliding latency window: enough depth that one p99 outlier
        # needs real company to breach, small enough to recover fast
        self.samples: "deque[float]" = deque(maxlen=64)
        self.opened_at = 0.0
        self.probing = False


class CircuitBreaker:
    """Per-digest closed -> open -> half-open -> closed machine over
    formation+dispatch latency. `decide(digest)` returns the route for
    one request: "batch" (ride the coalescing batcher), "shed"
    (immediate solo dispatch), or "probe" (the half-open trial riding
    the batcher); `observe(digest, seconds)` feeds the outcome back.
    Disabled (SLO 0) it answers "batch" on one branch — bit-parity
    with the pre-breaker tier."""

    def __init__(self, slo_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 clock=time.monotonic):
        self.slo = serve_slo_s() if slo_s is None else slo_s
        self.cooldown = (
            breaker_cooldown_s() if cooldown_s is None else cooldown_s
        )
        self.min_samples = (
            breaker_min_samples() if min_samples is None else min_samples
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._digests: Dict[str, _DigestState] = {}

    @property
    def enabled(self) -> bool:
        return self.slo > 0

    def state(self, digest: str) -> int:
        with self._lock:
            st = self._digests.get(digest)
            return CLOSED if st is None else st.state

    def _gauge(self, digest: str, st: _DigestState) -> None:
        telemetry.REGISTRY.set_gauge(f"breaker_state.{digest[:12]}",
                                     st.state)

    def _trip(self, digest: str, st: _DigestState, cause: str) -> None:
        st.state = OPEN
        st.opened_at = self._clock()
        st.probing = False
        ADMISSION_COUNTERS["breaker_trips"] += 1
        self._gauge(digest, st)
        telemetry.event(
            "admission.breaker_trip",
            {"digest": digest[:12], "cause": cause,
             "slo_ms": round(self.slo * 1000.0, 3)},
        )

    def decide(self, digest: str) -> str:
        if not self.enabled:
            return "batch"
        with self._lock:
            st = self._digests.get(digest)
            if st is None or st.state == CLOSED:
                return "batch"
            now = self._clock()
            if st.state == OPEN and now - st.opened_at >= self.cooldown:
                # cooldown elapsed: promote to HALF_OPEN and let ONE
                # probe ride the batcher; peers keep shedding until
                # the probe's verdict lands
                st.state = HALF_OPEN
                st.probing = True
                ADMISSION_COUNTERS["breaker_probes"] += 1
                self._gauge(digest, st)
                return "probe"
            if st.state == HALF_OPEN and not st.probing:
                st.probing = True
                ADMISSION_COUNTERS["breaker_probes"] += 1
                return "probe"
            return "shed"

    def observe(self, digest: str, seconds: float,
                probe: bool = False) -> None:
        """Feed one formation+dispatch latency back. A probe's verdict
        closes (within SLO) or re-opens the breaker; closed-state
        samples trip it when the sliding-window p99 breaches the
        SLO."""
        if not self.enabled:
            return
        with self._lock:
            st = self._digests.get(digest)
            if st is None:
                st = self._digests[digest] = _DigestState()
            st.samples.append(seconds)
            if probe:
                st.probing = False
                if seconds <= self.slo:
                    st.state = CLOSED
                    st.samples.clear()
                    ADMISSION_COUNTERS["breaker_closes"] += 1
                    self._gauge(digest, st)
                    telemetry.event(
                        "admission.breaker_close", {"digest": digest[:12]}
                    )
                else:
                    self._trip(digest, st, "probe_missed_slo")
                return
            if st.state != CLOSED:
                return
            n = len(st.samples)
            if n < self.min_samples:
                return
            p99 = sorted(st.samples)[min(n - 1, max(0, -(-99 * n // 100) - 1))]
            if p99 > self.slo:
                self._trip(digest, st, "p99_over_slo")

    def on_queue_full(self, digest: str) -> None:
        """Queue saturation is an immediate trip — no sample quorum:
        a full admission queue means formation is not keeping up."""
        if not self.enabled:
            return
        with self._lock:
            st = self._digests.get(digest)
            if st is None:
                st = self._digests[digest] = _DigestState()
            if st.state != OPEN:
                self._trip(digest, st, "queue_saturated")


class FrontDoor:
    """One serving session's traffic discipline: the admission
    controller and the circuit breaker, with limits resolved from the
    env at construction (one FrontDoor per Serve session, like the
    batcher)."""

    def __init__(self, clock=time.monotonic):
        self.admission = AdmissionController(clock=clock)
        self.breaker = CircuitBreaker(clock=clock)


def state_name(state: int) -> str:
    return _STATE_NAMES.get(state, str(state))
