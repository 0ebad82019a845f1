"""`serve`: a persistent, multi-client validate session on the card.

The port of the JAX package's guard_tpu/commands/serve.py. An embedder
that shells out to the CLI per call pays the interpreter, torch and the
kernel load every time; this command is spawned ONCE, then streams
newline-delimited JSON requests over stdin and answers one JSON
response line per request, with the kernels built and loaded before
the first answer.

A session reuses the PREPARED evaluation pipeline across requests:
rule payloads seen before are served from a parsed-RuleFile cache
(keyed by the exact rule texts, LRU-bounded at `_RULES_CACHE_MAX`, its
size on the `serve_rules_cache_size` gauge), and the plan layer's
process-global memo (ops/plan.py) is keyed by rule-content digest, so
a request whose rules arrive as new RuleFile objects still reuses the
lowered plan. A rules payload that fails to parse always takes the
uncached path, so its parse errors print as a lone run prints them.

Protocol (one line in, one line out):

  request:  {"rules": [..], "data": [..]}          (the payload
            contract) plus optional
            {"output_format": "sarif"|"json"|"yaml",
             "backend": "tpu"|"cpu"|"native"|"auto", "verbose": bool,
             "id": <any JSON scalar>, "tenant": <str>}
  response: {"code": <exit code 0|19|5>, "output": "<stdout text>",
             "error": "<stderr text>"}  (+ "id" echoed when tagged)

A request's backend defaults to `tpu`, the device path on the card the
session runs on (`device`: CUDA unless `--device` names another), as
the port's `validate` does (the JAX package defaults a request to
`auto`). With no card and no `--device` a `tpu` request answers the
code-5 envelope with the no-card message and the session keeps
serving: nothing falls back to the CPU.

**Concurrency** (serve/): untagged requests answer strictly in order.
Requests tagged with an `"id"` are MULTIPLEXED: handled on a worker
pool, answered as they finish (id echoed so clients demultiplex).
Requests whose backend resolves to `tpu` and whose rules parse clean
enter the coalescing batcher (serve/batcher.py): in-flight requests
that share a rule digest evaluate as ONE packed (documents x rules)
batch on the card and are demultiplexed byte for byte. `--listen
HOST:PORT` serves the same protocol to many TCP/HTTP clients over one
warm process (serve/server.py); `--no-coalesce` (`coalesce=False`)
turns coalescing off.

A `{"metrics": true}` request returns the live telemetry snapshot:
`{"code": 0, "metrics": {...}, "last_request": {...}}`: `metrics` is
the cumulative document `--metrics-out` writes (utils/telemetry.py),
with the persistent histograms `serve_request_seconds`,
`serve_queue_wait_seconds` and `serve_dispatch_seconds`;
`last_request` is the counter diff of the most recently completed
validate request (diffs are computed, never reset: a reset would race
in-flight peers).

**Traffic discipline** (serve/frontdoor.py): every validate request
resolves a tenant (the envelope's `"tenant"`, else the connection
default: the `X-Guard-Tenant` header, `--tenant`,
`GUARD_TPU_TENANT_DEFAULT`) and passes per-tenant admission
(token-bucket rate and in-flight ceiling). Over-quota requests answer
a structured 429-class envelope (code 5, `error_class`
`QuotaExceeded`/`QueueFull`, `retry_after_ms`). With
`GUARD_TPU_SERVE_SLO_MS` set, a per-digest circuit breaker sheds a
breached digest to immediate solo dispatch (the same bytes) until a
half-open probe meets the SLO again. `POST /webhook` is a Kubernetes
ValidatingWebhook face over the same handler, evaluated against the
`--rules` registry.

An empty line or EOF ends the session with exit code 0. A malformed or
poisoned request answers code 5 with an `error_class` and keeps the
session alive; `GUARD_TPU_SERVE_TIMEOUT=<seconds>` bounds each request
(`RequestTimeout`; the wedged worker thread is abandoned, at most
`GUARD_TPU_SERVE_ABANDONED_MAX` of them, on the
`serve_abandoned_threads` gauge). SIGTERM/SIGINT drain the session
(utils/journal.py): in-flight batches finish, queued requests answer
the `Draining` envelope, and the session exits 75.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from ..core.errors import ParseError
from ..core.parser import parse_rules_file
from ..ops.plan import plan_digest
from ..serve import frontdoor
from ..utils import telemetry
from ..utils.faults import maybe_fail
from ..utils.io import Reader, Writer
from ..utils.telemetry import ADMISSION_COUNTERS, SERVE_COUNTERS

log = logging.getLogger("guard_tpu_torch.serve")


def _serve_timeout() -> float:
    """Per-request bound in seconds (GUARD_TPU_SERVE_TIMEOUT); 0 or
    unset = unbounded direct call (zero overhead)."""
    raw = os.environ.get("GUARD_TPU_SERVE_TIMEOUT", "").strip()
    try:
        return float(raw) if raw else 0.0
    except ValueError:
        return 0.0


def _abandoned_max() -> int:
    """Ceiling on timeout-abandoned worker threads per session
    (GUARD_TPU_SERVE_ABANDONED_MAX, default 4)."""
    raw = os.environ.get("GUARD_TPU_SERVE_ABANDONED_MAX", "").strip()
    try:
        return int(raw) if raw else 4
    except ValueError:
        return 4


#: parsed-rules cache ceiling per session (rule registries are few and
#: stable in practice; the bound only guards a hostile request stream)
_RULES_CACHE_MAX = 8


class RequestTimeout(Exception):
    """One request exceeded GUARD_TPU_SERVE_TIMEOUT; the session
    answers with a structured error and keeps serving."""


def _counters_diff(before: dict, after: dict) -> dict:
    """Non-zero per-group counter deltas between two snapshots (the
    non-destructive replacement for the old per-request global reset)."""
    diff: dict = {}
    for group, counters in after.items():
        base = before.get(group, {})
        for name, val in counters.items():
            if not isinstance(val, (int, float)):
                continue
            delta = val - base.get(name, 0)
            if delta:
                diff.setdefault(group, {})[name] = delta
    return diff


@dataclass
class Serve:
    stdio: bool = True
    #: HOST:PORT for the TCP/HTTP listener (serve/server.py); None =
    #: stdio-only session
    listen: Optional[str] = None
    #: cross-request coalescing (serve/batcher.py); False = --no-coalesce
    coalesce: bool = True
    #: rule-registry file paths preloaded for the POST /webhook face
    #: (`serve --rules`); None = webhook answers fail-open with a
    #: "no rules configured" message
    rules: Optional[list] = None
    #: connection-default tenant id (`serve --tenant`); the request
    #: envelope's "tenant" and the X-Guard-Tenant header override it
    default_tenant: Optional[str] = None
    #: the torch device of every request's Validate: None = CUDA (a
    #: `tpu` request answers the no-card envelope without one); "cpu"
    #: runs the plain versions of the kernels (`serve --device`)
    device: Optional[str] = None
    # parsed RuleFile lists keyed by the exact rules-text tuple;
    # instance-scoped so sessions never share stale registries
    _rules_cache: "OrderedDict[tuple, list]" = field(
        default_factory=OrderedDict, repr=False
    )
    cache_hits: int = 0
    # lazily created single-worker executor for bounded requests
    # (GUARD_TPU_SERVE_TIMEOUT); abandoned + recreated after a timeout
    _executor: Optional[object] = field(default=None, repr=False)
    #: timeout-abandoned worker threads this session (satellite cap)
    _abandoned: int = 0
    _abandoned_warned: bool = False
    _cache_lock: object = field(default_factory=threading.Lock, repr=False)
    _metrics_lock: object = field(default_factory=threading.Lock, repr=False)
    _batcher_lock: object = field(
        default_factory=threading.Lock, repr=False
    )
    _batcher: Optional[object] = field(default=None, repr=False)
    _last_request: Optional[dict] = field(default=None, repr=False)
    _frontdoor_lock: object = field(
        default_factory=threading.Lock, repr=False
    )
    _frontdoor: Optional[object] = field(default=None, repr=False)
    # webhook registry texts, read once per session from self.rules
    _webhook_rules: Optional[list] = field(default=None, repr=False)
    #: graceful-drain latch (utils/journal.DrainLatch): SIGTERM/SIGINT
    #: trips it — the session stops accepting, finishes in-flight
    #: batches bounded by GUARD_TPU_DRAIN_TIMEOUT_MS, answers queued
    #: requests with a structured Draining envelope and exits
    #: DRAIN_EXIT_CODE. Injectable so tests trip it without signals.
    drain_latch: Optional[object] = None
    # the kernels and native libraries are loaded once, before the
    # first request on the device path (_warm)
    _warmed: bool = False
    _warm_lock: object = field(default_factory=threading.Lock, repr=False)

    # -- shared caches ------------------------------------------------
    def _prepared_rules(self, rules_strs):
        """Parsed RuleFile list for this request's rule texts, reused
        across requests (and across CLIENTS — one cache per session
        feeds every connection). Returns None when any text fails to
        parse — the request then takes the ordinary payload path so the
        parse error output reproduces exactly, and nothing is cached."""
        from .validate import RuleFile

        key = tuple(rules_strs)
        with self._cache_lock:
            hit = self._rules_cache.get(key)
            if hit is not None:
                self._rules_cache.move_to_end(key)
                self.cache_hits += 1
                return hit
        rule_files = []
        with telemetry.span("rule_parse", {"files": len(rules_strs)}):
            for i, content in enumerate(rules_strs):
                name = f"RULES_STDIN[{i + 1}]"
                try:
                    rf = parse_rules_file(content, name)
                except ParseError:
                    return None
                if rf is not None:
                    rule_files.append(
                        RuleFile(
                            name=name, full_name=name, content=content,
                            rules=rf
                        )
                    )
        with self._cache_lock:
            self._rules_cache[key] = rule_files
            while len(self._rules_cache) > _RULES_CACHE_MAX:
                self._rules_cache.popitem(last=False)
            telemetry.REGISTRY.set_gauge(
                "serve_rules_cache_size", len(self._rules_cache)
            )
        return rule_files

    def _warm(self) -> None:
        """Build and load the kernels on the session's card, and load
        the native encoder and oracle, once: concurrent first requests
        would otherwise each queue behind `nvcc` (kernels/build.py
        serializes the build). Without a card (and no `device`) there is
        nothing to load: each `tpu` request answers the no-card
        envelope. A build that fails raises into the request (and is
        retried by the next)."""
        with self._warm_lock:
            if self._warmed:
                return
            from ..ops import native_encoder, native_oracle
            from ..parallel.device import resolve_device

            try:
                dev = resolve_device(self.device)
            except RuntimeError:
                self._warmed = True
                return
            if dev.type == "cuda":
                from ..kernels.build import load

                load()
            native_encoder.native_available()
            native_oracle.native_available()
            self._warmed = True

    def _get_batcher(self):
        # lock-guarded: the first wave of concurrent requests all see
        # None and would each spin up a batcher (plus its dispatcher
        # thread), splitting one coalescable batch across strays
        with self._batcher_lock:
            if self._batcher is None:
                from ..serve.batcher import CoalescingBatcher

                self._batcher = CoalescingBatcher()
            return self._batcher

    def _get_frontdoor(self):
        # one FrontDoor per session, limits resolved from the env at
        # first use (same lifecycle as the batcher)
        with self._frontdoor_lock:
            if self._frontdoor is None:
                self._frontdoor = frontdoor.FrontDoor()
            return self._frontdoor

    def _tenant(self, req: dict, default_tenant: Optional[str]) -> str:
        """Resolve one request's tenant id: envelope field, then the
        transport's connection default (X-Guard-Tenant header), then
        the session default (--tenant), then the env default."""
        t = req.get("tenant")
        if isinstance(t, str) and t.strip():
            return t.strip()
        for cand in (default_tenant, self.default_tenant):
            if cand:
                return cand
        return frontdoor.default_tenant()

    # -- bounded execution --------------------------------------------
    def _run_bounded(self, cmd, buf, payload):
        """Run one request under GUARD_TPU_SERVE_TIMEOUT. The
        single-worker executor is created lazily and reused across
        requests; on timeout it is abandoned (its thread may still be
        wedged in a device call) and a fresh one serves the next
        request — up to GUARD_TPU_SERVE_ABANDONED_MAX abandonments,
        after which the session warns once and keeps the (possibly
        wedged) executor so a flaky device can't leak threads forever."""
        timeout = _serve_timeout()
        if timeout <= 0:
            return cmd.execute(buf, Reader.from_string(payload))
        from concurrent.futures import TimeoutError as FutTimeout
        from concurrent.futures import ThreadPoolExecutor

        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1)
        fut = self._executor.submit(
            cmd.execute, buf, Reader.from_string(payload)
        )
        try:
            return fut.result(timeout=timeout)
        except FutTimeout:
            if self._abandoned < _abandoned_max():
                ex, self._executor = self._executor, None
                ex.shutdown(wait=False)
                self._abandoned += 1
                SERVE_COUNTERS["abandoned_threads"] += 1
                telemetry.REGISTRY.set_gauge(
                    "serve_abandoned_threads", self._abandoned
                )
            elif not self._abandoned_warned:
                self._abandoned_warned = True
                log.warning(
                    "serve: abandoned-thread cap (%d) reached; keeping "
                    "the current worker — subsequent requests queue "
                    "behind it instead of leaking more threads",
                    _abandoned_max(),
                )
            raise RequestTimeout(
                f"request timed out after {timeout:g}s"
            )

    # -- request handling ---------------------------------------------
    @staticmethod
    def request_id(line: str):
        """The request's `"id"` tag, or None (malformed JSON included —
        the error envelope for it is produced untagged, in order)."""
        try:
            req = json.loads(line)
        except ValueError:
            return None
        if isinstance(req, dict):
            return req.get("id")
        return None

    def handle_line(self, line: str,
                    default_tenant: Optional[str] = None) -> dict:
        """Answer ONE request line with its response envelope (no id
        handling — callers echo ids). Every transport lands here: the
        stdio loop, the TCP/HTTP listener, the webhook and lambda
        faces, and the bench/parity harnesses driving a session
        in-process. `default_tenant` is the transport's connection
        default (e.g. the X-Guard-Tenant header)."""
        import time

        if self._draining():
            # drain contract: stop accepting — a queued or late request
            # answers the structured Draining envelope instead of
            # evaluating (never a hang, never a lost request)
            return self.draining_envelope()
        t0 = time.perf_counter()
        sp = telemetry.span_begin("serve_request")
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            resp = self._handle_request(req, sp, default_tenant)
        except frontdoor.AdmissionRejected as e:
            # traffic discipline, not a failure: the structured
            # 429-class envelope carries a retry hint and does NOT arm
            # the flight-recorder fault latch (an over-quota tenant
            # would otherwise turn every clean exit into a ring dump)
            sp.set("error_class", type(e).__name__)
            resp = {
                "code": 5,
                "output": "",
                "error": str(e),
                "error_class": type(e).__name__,
                "retry_after_ms": e.retry_after_ms,
            }
        except Exception as e:  # poisoned request: keep serving
            sp.set("error_class", type(e).__name__)
            # arm the flight recorder: a timed-out or poisoned
            # request answers code 5 but the SESSION exits 0, so
            # without this latch the abnormal-exit dump would never
            # fire for serve-side failures
            telemetry.flightrec_mark_fault(
                "serve.request_error",
                {"error_class": type(e).__name__},
            )
            resp = {
                "code": 5,
                "output": "",
                "error": str(e),
                "error_class": type(e).__name__,
            }
        telemetry.span_end(sp)
        # per-request latency distribution (p50/p99): persistent,
        # so a registry reset never erases the session story
        telemetry.REGISTRY.histogram(
            "serve_request_seconds", persistent=True
        ).observe(time.perf_counter() - t0)
        return resp

    def _handle_request(self, req: dict, sp,
                        default_tenant: Optional[str] = None) -> dict:
        if req.get("metrics"):
            # live observability face: `metrics` is the cumulative
            # snapshot --metrics-out writes; `last_request` the
            # counter DIFF of the most recent validate request
            # (computed, never reset — a global reset would race
            # concurrent in-flight peers)
            sp.set("kind", "metrics")
            with self._metrics_lock:
                last = self._last_request
            resp = {
                "code": 0,
                "metrics": telemetry.metrics_snapshot(),
                "last_request": last or {},
            }
            kernels = sys.modules.get("guard_tpu_torch.kernels")
            if kernels is not None:
                # the port's kernel launches in this process so far
                # (kernels.LAUNCHES), once the device path has run
                resp["launches"] = dict(kernels.LAUNCHES)
            return resp
        SERVE_COUNTERS["requests"] += 1
        # the front door: per-tenant admission BEFORE any evaluation
        # work — over-quota raises QuotaExceeded (structured 429-class
        # envelope upstream), never blocks
        fd = self._get_frontdoor()
        tenant = self._tenant(req, default_tenant)
        sp.set("tenant", tenant)
        fd.admission.admit(tenant)
        try:
            return self._handle_admitted(req, sp, fd)
        finally:
            fd.admission.release(tenant)

    def _handle_admitted(self, req: dict, sp, fd) -> dict:
        import time

        from ..serve.batcher import BatchTimeout
        from .validate import BACKENDS, Validate, resolve_backend

        rules_strs = req.get("rules", [])
        payload = json.dumps(
            {
                "rules": rules_strs,
                "data": req.get("data", []),
            }
        )
        prepared = None
        if all(isinstance(r, str) for r in rules_strs):
            prepared = self._prepared_rules(rules_strs)
        out_fmt = req.get("output_format", "sarif")
        structured = out_fmt in ("sarif", "json", "yaml", "junit")
        backend = req.get("backend", "tpu")
        cmd = Validate(
            payload=True,
            structured=structured,
            output_format=out_fmt,
            show_summary=["none"] if structured else ["fail"],
            verbose=bool(req.get("verbose", False)),
            backend=backend,
            prepared_rules=prepared,
            device=self.device,
        )
        device_path = backend in BACKENDS and resolve_backend(backend) == "tpu"
        if device_path:
            self._warm()
        buf = Writer.buffered()
        before = telemetry.REGISTRY.snapshot()["counters"]
        # coalescing eligibility: a request on the device path (its
        # backend resolved, `auto` never resolves to it) whose rules
        # parsed clean (the digest IS the group key); the host backends
        # keep the sequential path
        if self.coalesce and device_path and prepared is not None:
            SERVE_COUNTERS["coalesce_eligible"] += 1
            digest = plan_digest(prepared)
            # the circuit breaker routes this digest: "batch" rides
            # the coalescing batcher, "shed" (breaker OPEN) goes
            # straight to solo dispatch — byte-identical output, the
            # solo path IS the sequential path — and "probe" is the
            # half-open trial whose verdict re-closes or re-opens
            route = fd.breaker.decide(digest)
            if route == "shed":
                code = self._shed_solo(cmd, buf, payload, digest)
            else:
                t0 = time.perf_counter()
                try:
                    code = self._get_batcher().submit(
                        cmd, payload, digest, buf,
                        timeout=_serve_timeout(),
                        queue_wait=frontdoor.queue_wait_s(),
                    )
                except frontdoor.QueueFull:
                    # a saturated queue trips the breaker immediately;
                    # this request sheds to solo (shedding on) or
                    # answers the structured 429 (shedding off) — the
                    # accept loop never wedges either way
                    fd.breaker.on_queue_full(digest)
                    if route == "probe":
                        fd.breaker.observe(
                            digest, time.perf_counter() - t0, probe=True
                        )
                    if not frontdoor.shed_enabled():
                        ADMISSION_COUNTERS["rejected_queue_full"] += 1
                        raise
                    code = self._shed_solo(cmd, buf, payload, digest)
                except BatchTimeout as e:
                    if route == "probe":
                        # the probe's verdict must land even on
                        # timeout, or the half-open machine wedges
                        # with its probe slot forever taken
                        fd.breaker.observe(
                            digest, time.perf_counter() - t0, probe=True
                        )
                    raise RequestTimeout(str(e))
                else:
                    fd.breaker.observe(
                        digest, time.perf_counter() - t0,
                        probe=(route == "probe"),
                    )
        else:
            SERVE_COUNTERS["coalesce_bypass"] += 1
            code = self._run_bounded(cmd, buf, payload)
        after = telemetry.REGISTRY.snapshot()["counters"]
        with self._metrics_lock:
            self._last_request = _counters_diff(before, after)
        return {
            "code": code,
            "output": buf.out.getvalue(),
            "error": buf.err.getvalue(),
        }

    def _shed_solo(self, cmd, buf, payload, digest: str) -> int:
        """Overload shed: immediate solo dispatch, skipping the
        batcher entirely. The output is byte-identical to coalesced
        dispatch (the batch demux contract) — shedding trades batching
        efficiency for bounded latency, never correctness."""
        # the failure plane's shed leg: an injected shed fault still
        # answers a structured error envelope upstream
        maybe_fail("shed", key=digest)
        ADMISSION_COUNTERS["shed_solo"] += 1
        return self._run_bounded(cmd, buf, payload)

    # -- the webhook face ---------------------------------------------
    def handle_webhook(self, body: str,
                       default_tenant: Optional[str] = None):
        """Kubernetes ValidatingWebhook face: one AdmissionReview
        document in, the same AdmissionReview echoed back with a
        `response` verdict — `allowed` plus per-rule denial messages
        harvested from the SARIF results. Routes through
        `_handle_request`, so tenant quotas, the circuit breaker, and
        the coalescing batcher all apply. Returns
        `(http_status, response_doc)`; a malformed review is a 422,
        quota rejections are 429 (mapped by the transport)."""
        try:
            review = json.loads(body)
        except ValueError as e:
            return 422, {
                "error": f"unparseable AdmissionReview: {e}",
                "error_class": "ValueError",
            }
        if not isinstance(review, dict) or "request" not in review:
            return 422, {
                "error": "AdmissionReview must carry a `request` object",
                "error_class": "ValueError",
            }
        areq = review.get("request") or {}
        uid = areq.get("uid", "")
        obj = areq.get("object")
        base = {
            "apiVersion": review.get("apiVersion",
                                     "admission.k8s.io/v1"),
            "kind": review.get("kind", "AdmissionReview"),
        }
        texts = self._webhook_registry()
        if not texts:
            # fail-open, like a webhook with failurePolicy: Ignore —
            # an unconfigured registry must not brick a cluster
            base["response"] = {
                "uid": uid, "allowed": True,
                "status": {"message": "no rules configured "
                                      "(serve --rules)"},
            }
            return 200, base
        sp = telemetry.span_begin("serve_request")
        sp.set("kind", "webhook")
        try:
            resp = self._handle_request(
                {
                    "rules": texts,
                    "data": [json.dumps(obj if obj is not None else {})],
                    "backend": "tpu",
                    "output_format": "sarif",
                    "tenant": areq.get("tenant"),
                },
                sp, default_tenant,
            )
        except frontdoor.AdmissionRejected as e:
            telemetry.span_end(sp)
            return 429, {
                **base,
                "response": {
                    "uid": uid, "allowed": False,
                    "status": {"code": 429, "message": str(e)},
                },
                "retry_after_ms": e.retry_after_ms,
            }
        except Exception as e:  # noqa: BLE001 — webhook keeps serving
            sp.set("error_class", type(e).__name__)
            telemetry.span_end(sp)
            return 200, {
                **base,
                "response": {
                    "uid": uid, "allowed": True,
                    "status": {"message": f"evaluation error "
                                          f"(fail-open): {e}"},
                },
            }
        telemetry.span_end(sp)
        messages = []
        if resp["code"] != 0:
            try:
                sarif = json.loads(resp["output"])
                for res in sarif["runs"][0]["results"]:
                    rid = res.get("ruleId") or "RULE"
                    text = (res.get("message") or {}).get("text", "")
                    messages.append(f"{rid}: {text.strip()}".strip())
            except (ValueError, LookupError, TypeError):
                messages.append(resp.get("error") or
                                f"validation failed (code {resp['code']})")
        allowed = resp["code"] == 0
        base["response"] = {
            "uid": uid,
            "allowed": allowed,
            "status": {
                "code": 200 if allowed else 403,
                "message": "; ".join(messages) if messages else "ok",
            },
        }
        return 200, base

    def _webhook_registry(self) -> list:
        """Rule texts for the webhook face, read ONCE per session from
        the --rules paths (a serving registry is pinned at start, like
        the reference's compiled-artifact model)."""
        if self._webhook_rules is None:
            texts = []
            for path in self.rules or []:
                texts.append(
                    open(path, encoding="utf-8").read()
                )
            self._webhook_rules = texts
        return self._webhook_rules

    # -- graceful drain (the durability plane's serve leg) ------------
    def _draining(self) -> bool:
        latch = self.drain_latch
        return latch is not None and latch.tripped()

    @staticmethod
    def draining_envelope() -> dict:
        """The structured shutdown answer — the AdmissionRejected
        envelope shape, because a drain is traffic discipline, not a
        failure: the client should retry against the replacement
        process after the hinted backoff."""
        from ..utils.journal import drain_timeout_s

        return {
            "code": 5,
            "output": "",
            "error": "session draining (shutdown in progress)",
            "error_class": "Draining",
            "retry_after_ms": int(drain_timeout_s() * 1000),
        }

    def _drain_batcher(self) -> None:
        """Finish in-flight coalesced batches, bounded by the drain
        window; admitted work completes, nothing new is admitted."""
        with self._batcher_lock:
            b = self._batcher
        if b is None:
            return
        from ..utils.journal import drain_timeout_s

        try:
            if not b.drain(drain_timeout_s()):
                log.warning(
                    "drain timeout: abandoning in-flight batches"
                )
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass

    def _finish_pending(self, pending, writer, wlock) -> None:
        """Settle the multiplexed in-flight requests at session end.
        Clean EOF: wait for everything (the historical behavior). On
        drain: never-started requests cancel and answer the Draining
        envelope; started ones get the bounded window to finish, then
        are abandoned (their threads are replaced with the process)."""
        if not self._draining():
            for fut, _rid in pending:
                fut.result()
            return
        import time as _time
        from concurrent.futures import TimeoutError as _FutTimeout

        from ..utils.journal import drain_timeout_s

        deadline = _time.monotonic() + drain_timeout_s()
        for fut, rid in pending:
            if fut.cancel():
                resp = self.draining_envelope()
                if rid is not None:
                    resp["id"] = rid
                with wlock:
                    writer.writeln(json.dumps(resp))
                    writer.flush()
                continue
            try:
                fut.result(
                    timeout=max(0.0, deadline - _time.monotonic())
                )
            except _FutTimeout:
                log.warning(
                    "drain timeout: abandoning in-flight request"
                )
                break
            except Exception:  # noqa: BLE001
                pass  # _answer wrote its own error envelope

    # -- session loops ------------------------------------------------
    def execute(self, writer: Writer, reader: Reader) -> int:
        """Drain-latch lifecycle around the session body: SIGTERM/
        SIGINT handlers point at the latch (restored on exit), the
        coalescing batcher finishes its admitted work on the way out,
        and a tripped latch maps to the distinct drain exit code."""
        from ..utils import journal as jn

        if self.drain_latch is None:
            self.drain_latch = jn.DrainLatch()
        restore = jn.install_signal_drain(self.drain_latch)
        try:
            rc = self._execute(writer, reader)
        finally:
            restore()
            self._drain_batcher()
        if self.drain_latch.tripped():
            from ..utils.telemetry import RESUME_COUNTERS

            RESUME_COUNTERS["drained_sessions"] += 1
            return jn.DRAIN_EXIT_CODE
        return rc

    def _execute(self, writer: Writer, reader: Reader) -> int:
        server = None
        self._warm()
        if self.listen:
            from ..serve.server import ServeServer, run_listener

            if not self.stdio:
                return run_listener(self, self.listen, writer)
            # both transports: the listener serves sockets while the
            # stdio loop below serves the pipe; EOF on stdin ends both
            server = ServeServer(self, self.listen).start()
            writer.writeln_err(
                f"guard-tpu serve: listening on {server.host}:{server.port}"
            )

        wlock = threading.Lock()
        pool = None
        pending = []
        stream = reader.stream()
        try:
            for line in stream:
                line = line.strip()
                if not line:
                    break
                if self._draining():
                    # stop accepting: the line already read answers
                    # the Draining envelope, then the session ends
                    resp = self.draining_envelope()
                    rid = self.request_id(line)
                    if rid is not None:
                        resp["id"] = rid
                    with wlock:
                        writer.writeln(json.dumps(resp))
                        writer.flush()
                    break
                rid = self.request_id(line)
                if rid is None:
                    # untagged: answer strictly in order — the original
                    # single-client protocol, byte-compatible
                    resp = self.handle_line(line)
                    writer.writeln(json.dumps(resp))
                    writer.flush()
                    continue
                # tagged: multiplex — handled on the pool, answered as
                # finished (id echoed so the client demuxes), so many
                # in-flight requests can coalesce into shared batches
                if pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    from ..serve.batcher import coalesce_max_batch

                    pool = ThreadPoolExecutor(
                        max_workers=max(4, coalesce_max_batch()),
                        thread_name_prefix="guard-tpu-serve",
                    )

                def _answer(line=line, rid=rid):
                    resp = self.handle_line(line)
                    resp["id"] = rid
                    with wlock:
                        writer.writeln(json.dumps(resp))
                        writer.flush()

                pending.append((pool.submit(_answer), rid))
        finally:
            self._finish_pending(pending, writer, wlock)
            if pool is not None:
                pool.shutdown(wait=not self._draining())
            if server is not None:
                server.stop()
        return 0
