"""Cross-request batch coalescing for the serving plane.

The JAX package's guard_tpu/serve/batcher.py, on the port's device
path. `serve` answers one request per device dispatch even when sixteen
clients ask about the SAME rule registry: the plan is warm
(ops/plan.py), so the marginal cost of a request is its dispatch, and
a dispatch over 4 documents leaves the card almost idle. The batcher
closes that gap: in-flight validate requests enter a bounded queue,
are grouped by rule-content digest (the plan-cache key: same digest,
same lowered program), and each group evaluates as ONE packed
(documents x rules) batch through `ops.backend.tpu_validate_multi`.
Each request's slice of the shared statuses and rim blocks is
demultiplexed back to it, byte for byte what a sequential run prints
(statuses do not depend on the batch a document rides in: the plan
layer's relocation contract).

Latency policy: the dispatcher thread waits at most
`GUARD_TPU_COALESCE_WAIT_MS` (default 5) after the first arrival for
peers to join, and never packs more than
`GUARD_TPU_COALESCE_MAX_BATCH` (default 16) requests into one batch.
The admission queue holds at most `GUARD_TPU_SERVE_QUEUE_MAX`
(default 64) requests; a full queue blocks admission (backpressure,
never silent drops) unless the caller passes a bounded `queue_wait`,
in which case admission past the deadline raises
`frontdoor.QueueFull` so the front door can shed the request to solo
dispatch or answer a structured 429. Coalescing is a session setting
(`Serve.coalesce`, `serve --no-coalesce`); the port has no
GUARD_TPU_COALESCE twin.

Failure isolation: the `serve_batch` fault point fires per group
before dispatch; an injected or real shared-phase failure (a kernel
or CUDA error among them) re-fires every member SOLO through the
ordinary sequential path (`isolation_refires` counts them), a
per-request report-phase failure is captured into that request's slot
only, and a request whose PREPARE step fails (e.g. a poisoned document
payload) drops out of the group and runs solo so its error output
reproduces byte for byte; its peers still coalesce. A timed-out waiter
abandons its slot (`request_timeouts`); the batch result is discarded
for that request, never for its peers.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from ..utils import telemetry
from ..utils.faults import maybe_fail
from ..utils.io import Reader
from ..utils.telemetry import SERVE_COUNTERS


def coalesce_wait_s() -> float:
    """Batch-formation window after the first arrival, in seconds
    (GUARD_TPU_COALESCE_WAIT_MS, default 5ms) — the latency-SLO knob:
    longer windows fill batches, shorter ones bound p50."""
    raw = os.environ.get("GUARD_TPU_COALESCE_WAIT_MS", "").strip()
    try:
        return (float(raw) if raw else 5.0) / 1000.0
    except ValueError:
        return 0.005


def coalesce_max_batch() -> int:
    raw = os.environ.get("GUARD_TPU_COALESCE_MAX_BATCH", "").strip()
    try:
        n = int(raw) if raw else 16
    except ValueError:
        n = 16
    return max(1, n)


def serve_queue_max() -> int:
    raw = os.environ.get("GUARD_TPU_SERVE_QUEUE_MAX", "").strip()
    try:
        n = int(raw) if raw else 64
    except ValueError:
        n = 64
    return max(1, n)


class BatchTimeout(Exception):
    """A submitter's wait expired before its batch answered; the
    serve layer maps this to the session's RequestTimeout contract."""


class _Item:
    """One admitted request: the serve-built Validate command, its raw
    payload text, the digest it groups under, and the per-request
    buffered writer the demuxed report pass emits into."""

    __slots__ = (
        "cmd", "payload", "digest", "writer",
        "done", "code", "error", "enqueued_at", "arrived_alone",
    )

    def __init__(self, cmd, payload, digest, writer):
        self.cmd = cmd
        self.payload = payload
        self.digest = digest
        self.writer = writer
        self.done = threading.Event()
        self.code: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()
        self.arrived_alone = False


class CoalescingBatcher:
    """Bounded admission queue + dispatcher thread. `submit()` blocks
    the calling request thread until its item is answered (or its
    timeout expires); the dispatcher drains arrivals in max-wait/
    max-batch windows and evaluates each digest group as one batch."""

    def __init__(self, wait_s: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 queue_limit: Optional[int] = None):
        self._wait = coalesce_wait_s() if wait_s is None else wait_s
        self._max_batch = (
            coalesce_max_batch() if max_batch is None else max_batch
        )
        self._limit = serve_queue_max() if queue_limit is None else queue_limit
        self._q: "deque[_Item]" = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="guard-tpu-coalescer"
        )
        self._thread.start()

    # -- admission ----------------------------------------------------
    def submit(self, cmd, payload: str, digest: str, writer,
               timeout: float = 0.0,
               queue_wait: Optional[float] = None) -> int:
        """Admit one request and block until it is answered. Raises
        BatchTimeout when `timeout` (seconds, 0 = unbounded) expires
        first — the batch keeps running, the result is discarded — and
        re-raises whatever per-request exception the run captured.

        `queue_wait` bounds the ADMISSION wait on a full queue:
        None keeps the legacy infinite backpressure; a number of
        seconds raises `frontdoor.QueueFull` past the deadline so the
        front door can shed or 429 instead of wedging the caller."""
        item = _Item(cmd, payload, digest, writer)
        with self._cv:
            if queue_wait is None:
                while len(self._q) >= self._limit and not self._closed:
                    # bounded admission: backpressure, not drops
                    self._cv.wait(0.05)
            else:
                deadline = time.monotonic() + max(0.0, queue_wait)
                while len(self._q) >= self._limit and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        from .frontdoor import QueueFull

                        raise QueueFull(
                            f"admission queue full ({self._limit}) "
                            f"past {queue_wait * 1000:g}ms wait",
                            retry_after_ms=max(
                                1, int(queue_wait * 1000) or 100
                            ),
                        )
                    self._cv.wait(min(remaining, 0.05))
            if self._closed:
                raise RuntimeError("serve batcher is closed")
            item.arrived_alone = not self._q
            self._q.append(item)
            telemetry.REGISTRY.set_gauge("serve_queue_depth", len(self._q))
            self._cv.notify_all()
        if not item.done.wait(timeout if timeout and timeout > 0 else None):
            SERVE_COUNTERS["request_timeouts"] += 1
            raise BatchTimeout(f"request timed out after {timeout:g}s")
        if item.error is not None:
            raise item.error
        return item.code

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown (the durability plane's serve leg): stop
        admitting — `submit` raises once closed — let the dispatcher
        finish every already-admitted batch, and join it bounded by
        `timeout` seconds. Returns True when the queue fully drained
        inside the bound (False = in-flight work abandoned to the
        daemonic dispatcher, same as any process exit)."""
        self.close()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- dispatcher ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q and self._closed:
                    return
                # batch formation: after the first arrival, wait up to
                # the coalesce window for peers (or until max-batch) —
                # UNLESS the sole queued request found the queue empty
                # on admission: with no peer in flight the window buys
                # only latency, so dispatch immediately (c=1 parity
                # with coalesce-off). Concurrent arrivals — a request
                # admitted while others were queued — still pay the
                # window so their peers can join the batch.
                if len(self._q) == 1 and self._q[0].arrived_alone:
                    SERVE_COUNTERS["coalesce_window_adaptive"] += 1
                else:
                    deadline = time.monotonic() + self._wait
                    while len(self._q) < self._max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                batch = [
                    self._q.popleft()
                    for _ in range(min(len(self._q), self._max_batch))
                ]
                telemetry.REGISTRY.set_gauge("serve_queue_depth", len(self._q))
                self._cv.notify_all()
            wait_hist = telemetry.REGISTRY.histogram(
                "serve_queue_wait_seconds", persistent=True
            )
            now = time.monotonic()
            for it in batch:
                wait_hist.observe(now - it.enqueued_at)
            groups: "dict[str, list]" = {}
            for it in batch:
                groups.setdefault(it.digest, []).append(it)
            for digest, items in groups.items():
                try:
                    self._run_group(digest, items)
                except Exception as e:  # noqa: BLE001 — keep serving
                    for it in items:
                        if not it.done.is_set():
                            it.error = e
                            it.done.set()

    # -- evaluation ---------------------------------------------------
    def _run_solo(self, item: _Item) -> None:
        """The sequential path, verbatim: exactly what a lone stdio
        request runs, so output/exit code reproduce byte-for-byte."""
        try:
            item.code = item.cmd.execute(
                item.writer, Reader.from_string(item.payload)
            )
        except Exception as e:  # noqa: BLE001 — per-request isolation
            item.error = e
        finally:
            item.done.set()

    def _run_group(self, digest: str, items: list) -> None:
        telemetry.REGISTRY.set_gauge("serve_batch_fill", len(items))
        try:
            # the failure plane's serving leg: a batch-scoped fault
            # (injected via GUARD_TPU_FAULT=serve_batch:... or a real
            # shared-phase error below) quarantines the BATCH, not the
            # session — every member re-fires solo
            maybe_fail("serve_batch", key=digest)
        except Exception:
            SERVE_COUNTERS["isolation_refires"] += len(items)
            for it in items:
                self._run_solo(it)
            return
        if len(items) == 1:
            SERVE_COUNTERS["singleton_batches"] += 1
            self._run_solo(items[0])
            return

        from ..commands.validate import payload_inputs

        reqs = []
        members = []
        for it in items:
            try:
                # the sequential payload branch, minus the per-request
                # work coalescing amortizes: prepared rules are already
                # parsed (eligibility requires it), so payload_inputs
                # only decodes documents — any failure here (e.g. a
                # poisoned document) drops this request to the solo
                # path where its error output reproduces exactly
                rule_files, data_files, _errs = payload_inputs(
                    it.payload, it.writer, it.cmd.prepared_rules
                )
                reqs.append((it.cmd, rule_files, data_files, it.writer))
                members.append(it)
            except Exception:
                SERVE_COUNTERS["solo_fallbacks"] += 1
                self._run_solo(it)
        if not members:
            return
        if len(members) == 1:
            SERVE_COUNTERS["singleton_batches"] += 1
            self._run_solo(members[0])
            return

        from ..ops.backend import tpu_validate_multi

        try:
            outcomes = tpu_validate_multi(reqs)
        except Exception:
            # shared phase (encode/lower/dispatch) failed: nobody has
            # written output yet, so every member re-fires solo
            SERVE_COUNTERS["isolation_refires"] += len(members)
            for it in members:
                self._run_solo(it)
            return
        SERVE_COUNTERS["coalesced_batches"] += 1
        SERVE_COUNTERS["coalesced_requests"] += len(members)
        for it, out in zip(members, outcomes):
            if isinstance(out, BaseException):
                it.error = out
            else:
                it.code = out
            it.done.set()
