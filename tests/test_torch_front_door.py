"""The port's serving front door (guard_tpu_torch/serve/frontdoor.py)
against the JAX package's, on the CPU.

The cases of tests/test_front_door.py but its `sweep --follow` ones
(tests/test_torch_follow.py holds those): the circuit breaker and the
quota machines on an INJECTED clock (no wall time in any assertion),
quota isolation in a session, the queue-full shed and 429, the
latency trip, the batcher's bounded admission wait, the transport's
body caps and 429 over a real listener, the webhook face, the Lambda
front door and the front door's fault points. Where a session answers
a request, its envelope must equal the JAX package's for the same
request line. Every socket and join is bounded.
"""

import json
import socket
import threading
import time

import pytest

from guard_tpu_torch.commands.serve import Serve
from guard_tpu_torch.serve import frontdoor
from guard_tpu_torch.serve.frontdoor import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    AdmissionController,
    CircuitBreaker,
    QuotaExceeded,
)
from guard_tpu_torch.utils.faults import POINTS, reset_faults
from guard_tpu_torch.utils.io import Writer
from guard_tpu_torch.utils.telemetry import ADMISSION_COUNTERS
from test_torch_ingest import set_encoders

RULES = "rule has_a { a exists }"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_COALESCE", "GUARD_TPU_COALESCE_WAIT_MS",
                 "GUARD_TPU_SERVE_SLO_MS", "GUARD_TPU_SERVE_SHED", "GUARD_TPU_SERVE_MAX_BODY",
                 "GUARD_TPU_BREAKER_COOLDOWN_MS", "GUARD_TPU_TENANT_RATE",
                 "GUARD_TPU_TENANT_BURST", "GUARD_TPU_TENANT_DEFAULT", "GUARD_TPU_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)


class Clock:
    """Deterministic monotonic clock for the front-door machines."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _req(backend="cpu", doc='{"a": 1}', **extra):
    return json.dumps({"rules": [RULES], "data": [doc], "backend": backend, **extra})


def jax_answer(line, **kw):
    """The JAX package's session envelope for one request line."""
    from guard_tpu.commands.serve import Serve as JaxServe

    return JaxServe(stdio=True, **kw).handle_line(line)


# -- circuit breaker state machine ---------------------------------------

def test_breaker_full_cycle_closed_open_half_open_closed():
    clk = Clock()
    br = CircuitBreaker(slo_s=0.05, cooldown_s=1.0, min_samples=4, clock=clk)
    assert br.enabled
    assert br.state("d") == CLOSED
    assert br.decide("d") == "batch"
    for _ in range(3):  # below the sample quorum a breach cannot trip
        br.observe("d", 0.2)
    assert br.state("d") == CLOSED
    br.observe("d", 0.2)
    assert br.state("d") == OPEN
    assert br.decide("d") == "shed"
    clk.advance(0.5)
    assert br.decide("d") == "shed"
    clk.advance(0.6)  # past the cooldown: ONE probe
    assert br.decide("d") == "probe"
    assert br.state("d") == HALF_OPEN
    assert br.decide("d") == "shed"
    br.observe("d", 0.01, probe=True)
    assert br.state("d") == CLOSED
    assert br.decide("d") == "batch"
    for _ in range(3):  # a cleared window needs a fresh quorum
        br.observe("d", 0.2)
    assert br.state("d") == CLOSED


def test_breaker_probe_miss_reopens():
    clk = Clock()
    br = CircuitBreaker(slo_s=0.05, cooldown_s=1.0, min_samples=2, clock=clk)
    br.observe("d", 0.2)
    br.observe("d", 0.2)
    assert br.state("d") == OPEN
    clk.advance(1.0)
    assert br.decide("d") == "probe"
    br.observe("d", 0.2, probe=True)
    assert br.state("d") == OPEN
    assert br.decide("d") == "shed"
    clk.advance(1.0)
    assert br.decide("d") == "probe"


def test_breaker_fast_samples_never_trip():
    br = CircuitBreaker(slo_s=0.05, cooldown_s=1.0, min_samples=2, clock=Clock())
    for _ in range(20):
        br.observe("d", 0.001)
    assert br.state("d") == CLOSED
    assert br.decide("d") == "batch"


def test_breaker_queue_saturation_trips_immediately():
    br = CircuitBreaker(slo_s=0.05, cooldown_s=1.0, min_samples=8, clock=Clock())
    b0 = ADMISSION_COUNTERS["breaker_trips"]
    br.on_queue_full("d")
    assert br.state("d") == OPEN
    assert br.decide("d") == "shed"
    assert ADMISSION_COUNTERS["breaker_trips"] - b0 == 1


def test_breaker_disabled_is_inert():
    br = CircuitBreaker(slo_s=0.0, cooldown_s=1.0, min_samples=1, clock=Clock())
    assert not br.enabled
    for _ in range(10):
        br.observe("d", 99.0)
    br.on_queue_full("d")
    assert br.state("d") == CLOSED
    assert br.decide("d") == "batch"


def test_breaker_isolates_digests():
    br = CircuitBreaker(slo_s=0.05, cooldown_s=1.0, min_samples=1, clock=Clock())
    br.observe("hot", 0.2)
    assert br.state("hot") == OPEN
    assert br.decide("hot") == "shed"
    assert br.state("cold") == CLOSED
    assert br.decide("cold") == "batch"


# -- admission controller -------------------------------------------------

def test_admission_rate_bucket_refills_on_clock():
    clk = Clock()
    ac = AdmissionController(rate=2.0, burst=2.0, max_inflight=0, clock=clk)
    ac.admit("t")
    ac.admit("t")
    with pytest.raises(QuotaExceeded) as ei:
        ac.admit("t")
    assert ei.value.retry_after_ms == 500
    clk.advance(0.5)  # exactly one token
    ac.admit("t")
    with pytest.raises(QuotaExceeded):
        ac.admit("t")


def test_admission_inflight_ceiling_and_release():
    ac = AdmissionController(rate=0.0, burst=1.0, max_inflight=2, clock=Clock())
    ac.admit("t")
    ac.admit("t")
    with pytest.raises(QuotaExceeded) as ei:
        ac.admit("t")
    assert ei.value.retry_after_ms == 100
    ac.release("t")
    ac.admit("t")


def test_admission_buckets_are_per_tenant():
    ac = AdmissionController(rate=1.0, burst=1.0, max_inflight=0, clock=Clock())
    ac.admit("hot")
    with pytest.raises(QuotaExceeded):
        ac.admit("hot")
    ac.admit("quiet")


def test_admission_unlimited_is_inert():
    ac = AdmissionController(rate=0.0, burst=1.0, max_inflight=0, clock=Clock())
    for _ in range(100):
        ac.admit("t")


# -- serve-level quota isolation ------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_serve_quota_rejection_envelope_and_quiet_parity(backend):
    """A hot tenant over its bucket gets the structured 429-class
    envelope; the quiet tenant's envelope is an unthrottled session's,
    and the JAX package's."""
    clk = Clock()
    quiet_line = _req(backend, tenant="quiet")
    hot_line = _req(backend, tenant="hot")
    baseline = Serve(stdio=True, device="cpu").handle_line(quiet_line)
    assert baseline == jax_answer(quiet_line) and baseline["code"] == 0

    srv = Serve(stdio=True, device="cpu")
    srv._get_frontdoor().admission = AdmissionController(rate=1.0, burst=1.0,
                                                         max_inflight=0, clock=clk)
    r0 = ADMISSION_COUNTERS["rejected_rate"]
    assert srv.handle_line(hot_line)["code"] == 0
    for _ in range(3):
        rej = srv.handle_line(hot_line)
        assert rej["code"] == 5
        assert rej["error_class"] == "QuotaExceeded"
        assert rej["retry_after_ms"] == 1000
        assert "hot" in rej["error"]
    assert ADMISSION_COUNTERS["rejected_rate"] - r0 == 3
    assert srv.handle_line(quiet_line) == baseline
    clk.advance(1.0)
    assert srv.handle_line(hot_line)["code"] == 0


# -- queue-full: shed vs structured 429 -----------------------------------

class _AlwaysFull:
    """Batcher stub whose admission queue never drains."""

    def __init__(self):
        self.calls = 0

    def submit(self, *a, **kw):
        self.calls += 1
        raise frontdoor.QueueFull("admission queue full (stub)", retry_after_ms=25)


def test_queue_full_sheds_to_solo_byte_identical():
    line = _req(backend="tpu")
    solo = Serve(stdio=True, coalesce=False, device="cpu").handle_line(line)
    assert solo["code"] == 0 and solo == jax_answer(line)
    srv = Serve(stdio=True, coalesce=True, device="cpu")
    srv._batcher = _AlwaysFull()
    s0 = ADMISSION_COUNTERS["shed_solo"]
    assert srv.handle_line(line) == solo
    assert ADMISSION_COUNTERS["shed_solo"] - s0 == 1


def test_queue_full_rejects_when_shed_disabled(monkeypatch):
    monkeypatch.setenv("GUARD_TPU_SERVE_SHED", "0")
    srv = Serve(stdio=True, coalesce=True, device="cpu")
    srv._batcher = _AlwaysFull()
    q0 = ADMISSION_COUNTERS["rejected_queue_full"]
    resp = srv.handle_line(_req(backend="tpu"))
    assert resp["code"] == 5
    assert resp["error_class"] == "QueueFull"
    assert resp["retry_after_ms"] == 25
    assert ADMISSION_COUNTERS["rejected_queue_full"] - q0 == 1


def test_queue_full_trips_breaker_and_opens_shed_route(monkeypatch):
    """With an SLO set, one saturated-queue event trips the breaker and
    the next same-digest request sheds without touching the batcher."""
    monkeypatch.setenv("GUARD_TPU_SERVE_SLO_MS", "5000")
    monkeypatch.setenv("GUARD_TPU_BREAKER_COOLDOWN_MS", "3600000")
    line = _req(backend="tpu")
    solo = Serve(stdio=True, coalesce=False, device="cpu").handle_line(line)
    srv = Serve(stdio=True, coalesce=True, device="cpu")
    stub = srv._batcher = _AlwaysFull()
    b0 = ADMISSION_COUNTERS["breaker_trips"]
    assert srv.handle_line(line) == solo
    assert ADMISSION_COUNTERS["breaker_trips"] - b0 == 1
    assert stub.calls == 1
    assert srv.handle_line(line) == solo
    assert stub.calls == 1


def test_serve_breaker_sheds_after_latency_trip(monkeypatch):
    """The real batcher path: a 1 ns SLO means the first observed
    formation+dispatch latency trips the breaker; the second request
    sheds, with the sequential bytes."""
    from guard_tpu_torch.ops.plan import plan_digest

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "0")
    line = _req(backend="tpu")
    solo = Serve(stdio=True, coalesce=False, device="cpu").handle_line(line)
    srv = Serve(stdio=True, coalesce=True, device="cpu")
    srv._get_frontdoor().breaker = CircuitBreaker(slo_s=1e-9, cooldown_s=3600.0,
                                                  min_samples=1, clock=Clock())
    assert srv.handle_line(line) == solo
    digest = plan_digest(srv._prepared_rules((RULES,)))
    assert srv._get_frontdoor().breaker.state(digest) == OPEN
    s0 = ADMISSION_COUNTERS["shed_solo"]
    assert srv.handle_line(line) == solo
    assert ADMISSION_COUNTERS["shed_solo"] - s0 == 1


def test_batcher_bounded_queue_wait_raises_queue_full():
    """submit(queue_wait=...) never wedges on a full admission queue:
    past the bounded wait it raises QueueFull."""
    from guard_tpu_torch.serve.batcher import CoalescingBatcher

    ev = threading.Event()
    started = threading.Event()

    class _Slow:
        def execute(self, writer, reader):
            started.set()
            ev.wait(30)
            return 0

    b = CoalescingBatcher(wait_s=5.0, max_batch=8, queue_limit=1)
    try:
        t1 = threading.Thread(target=b.submit, args=(_Slow(), "{}", "d1", Writer.buffered()),
                              daemon=True)
        t1.start()
        assert started.wait(10)  # the dispatcher is wedged in t1
        t2 = threading.Thread(target=b.submit, args=(_Slow(), "{}", "d2", Writer.buffered()),
                              daemon=True)
        t2.start()
        deadline = time.monotonic() + 10
        while len(b._q) < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(b._q) == 1
        with pytest.raises(frontdoor.QueueFull):
            b.submit(_Slow(), "{}", "d3", Writer.buffered(), queue_wait=0.05)
        ev.set()
        t1.join(30)
        t2.join(30)
        assert not t1.is_alive() and not t2.is_alive()
    finally:
        ev.set()
        b.close()


def test_batcher_drain_finishes_admitted_work():
    """drain() stops admission and lets the dispatcher finish what it
    admitted, bounded; a later submit raises."""
    from guard_tpu_torch.serve.batcher import CoalescingBatcher

    class _Quick:
        def execute(self, writer, reader):
            time.sleep(0.05)
            return 0

    b = CoalescingBatcher(wait_s=0.0, max_batch=4, queue_limit=8)
    codes = []
    t = threading.Thread(target=lambda: codes.append(
        b.submit(_Quick(), "{}", "d", Writer.buffered())), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not b._q and not codes and time.monotonic() < deadline:
        time.sleep(0.001)
    assert b.drain(10)
    t.join(10)
    assert codes == [0]
    with pytest.raises(RuntimeError):
        b.submit(_Quick(), "{}", "d", Writer.buffered())


# -- transport input bounds ----------------------------------------------

def _http(port, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), json.loads(resp.read())
    finally:
        conn.close()


def test_http_body_cap_answers_413(monkeypatch):
    from guard_tpu_torch.serve.server import ServeServer

    monkeypatch.setenv("GUARD_TPU_SERVE_MAX_BODY", "200")
    server = ServeServer(Serve(stdio=False, device="cpu"), "127.0.0.1:0").start()
    try:
        s0 = ADMISSION_COUNTERS["rejected_body_size"]
        status, _, body = _http(server.port, "POST", "/validate", "x" * 1000)
        assert status == 413
        assert body["error_class"] == "BodyTooLarge"
        assert ADMISSION_COUNTERS["rejected_body_size"] - s0 == 1
        status, _, body = _http(server.port, "POST", "/validate", _req())
        assert status == 200 and body == jax_answer(_req())
    finally:
        server.stop()


def test_jsonl_line_cap_keeps_session_alive(monkeypatch):
    from guard_tpu_torch.serve.server import ServeServer

    monkeypatch.setenv("GUARD_TPU_SERVE_MAX_BODY", "200")
    server = ServeServer(Serve(stdio=False, device="cpu"), "127.0.0.1:0").start()
    try:
        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
            f = s.makefile("rwb")
            f.write((json.dumps({"junk": "y" * 500}) + "\n").encode())
            f.write((_req(backend="tpu") + "\n").encode())
            f.flush()
            s.shutdown(socket.SHUT_WR)
            first = json.loads(f.readline())
            second = json.loads(f.readline())
        assert first["code"] == 5
        assert first["error_class"] == "BodyTooLarge"
        assert second["code"] == 0 and second == jax_answer(_req(backend="tpu"))
    finally:
        server.stop()


def test_http_quota_rejection_maps_to_429(monkeypatch):
    from guard_tpu_torch.serve.server import ServeServer

    monkeypatch.setenv("GUARD_TPU_TENANT_RATE", "1")
    server = ServeServer(Serve(stdio=False, device="cpu"), "127.0.0.1:0").start()
    try:
        status, _, body = _http(server.port, "POST", "/validate", _req())
        assert status == 200 and body["code"] == 0
        status, retry_after, body = _http(server.port, "POST", "/validate", _req())
        assert status == 429
        assert body["error_class"] == "QuotaExceeded"
        assert int(retry_after) >= 1
    finally:
        server.stop()


def test_listener_drain_answers_queued_connections():
    """On a drain the listener accepts the connections the kernel had
    already queued, and the session answers each the Draining envelope
    instead of the reset a bare close would give; then it is idle."""
    import http.client

    from guard_tpu_torch.serve.server import ServeServer
    from guard_tpu_torch.utils.journal import DrainLatch

    latch = DrainLatch()
    server = ServeServer(Serve(stdio=False, device="cpu", drain_latch=latch),
                         "127.0.0.1:0").start()
    conns = []
    try:
        # the accept loop returns (it polls every 0.1 s), so what
        # connects now waits in the kernel's queue
        server._stopped.set()
        server._accept_thread.join(10)
        assert not server._accept_thread.is_alive()
        for _ in range(3):
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
            conn.request("POST", "/validate", body=_req())
            conns.append(conn)
        latch.trip("test")
        server.stop(drain=True)
        for conn in conns:
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 422 and body["error_class"] == "Draining"
        assert server.wait_idle(30)
    finally:
        for conn in conns:
            conn.close()
        server.stop()


# -- the webhook face -----------------------------------------------------

def _review(obj, uid="uid-1"):
    return json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                       "request": {"uid": uid, "object": obj}})


@pytest.fixture
def webhook_registry(tmp_path):
    reg = tmp_path / "registry.guard"
    reg.write_text(RULES)
    return [str(reg)]


def webhook_both(registry, body):
    """The port's and the JAX package's webhook answers to one body."""
    from guard_tpu.commands.serve import Serve as JaxServe

    got = Serve(stdio=True, rules=registry, device="cpu").handle_webhook(body)
    assert got == JaxServe(stdio=True, rules=registry).handle_webhook(body)
    return got


def test_webhook_allows_compliant_object(webhook_registry):
    status, doc = webhook_both(webhook_registry, _review({"a": 1}))
    assert status == 200
    r = doc["response"]
    assert r["uid"] == "uid-1" and r["allowed"] is True and r["status"]["code"] == 200
    assert doc["kind"] == "AdmissionReview"


def test_webhook_denies_with_rule_messages(webhook_registry):
    status, doc = webhook_both(webhook_registry, _review({"b": 2}, uid="uid-2"))
    assert status == 200
    r = doc["response"]
    assert r["uid"] == "uid-2" and r["allowed"] is False and r["status"]["code"] == 403
    assert "has_a" in r["status"]["message"].lower()


def test_webhook_malformed_review_is_422(webhook_registry):
    status, doc = webhook_both(webhook_registry, "{not json")
    assert status == 422 and doc["error_class"] == "ValueError"
    status, _doc = webhook_both(webhook_registry, json.dumps({"kind": "X"}))
    assert status == 422


def test_webhook_without_registry_fails_open():
    status, doc = webhook_both(None, _review({"b": 2}))
    assert status == 200
    assert doc["response"]["allowed"] is True
    assert "no rules configured" in doc["response"]["status"]["message"]


def test_webhook_over_http_listener(webhook_registry):
    """POST /webhook through the listener answers the session's verdict."""
    from guard_tpu_torch.serve.server import ServeServer

    srv = Serve(stdio=False, rules=webhook_registry, device="cpu")
    server = ServeServer(srv, "127.0.0.1:0").start()
    try:
        status, _, doc = _http(server.port, "POST", "/webhook", _review({"b": 2}, uid="u"))
        assert status == 200 and doc == srv.handle_webhook(_review({"b": 2}, uid="u"))[1]
        status, _, doc = _http(server.port, "POST", "/webhook", "{oops")
        assert status == 422
    finally:
        server.stop()


# -- the Lambda front door ------------------------------------------------

def test_lambda_legacy_event_shape_is_preserved(monkeypatch):
    from guard_tpu import lambda_handler as jax_lambda
    from guard_tpu_torch import lambda_handler

    monkeypatch.setattr(lambda_handler, "_SESSION", None)
    ev = {"data": '{"a": 1}', "rules": [RULES], "verbose": False}
    out = lambda_handler.handler(ev)
    assert set(out) == {"message"} and len(out["message"]) == 1
    assert out == jax_lambda.handler(ev)


def test_lambda_frontdoor_event_routes_through_serve(monkeypatch):
    from guard_tpu import lambda_handler as jax_lambda
    from guard_tpu_torch import lambda_handler

    monkeypatch.setattr(lambda_handler, "_SESSION", None)
    monkeypatch.setattr(jax_lambda, "_SESSION", None)
    ok_ev = {"documents": [{"a": 1}], "rules": [RULES], "backend": "cpu"}
    ok = lambda_handler.handler(ok_ev)
    assert ok["code"] == 0 and json.loads(ok["output"])["version"] == "2.1.0"
    assert ok == jax_lambda.handler(ok_ev)
    fail = lambda_handler.handler({"documents": [{"b": 2}], "rules": [RULES], "backend": "cpu"})
    assert fail["code"] == 19
    monkeypatch.setattr(jax_lambda, "_SESSION", None)


def test_lambda_frontdoor_quota_rejection_is_structured(monkeypatch):
    from guard_tpu_torch import lambda_handler

    monkeypatch.setattr(lambda_handler, "_SESSION", None)
    clk = Clock()
    ev = {"documents": [{"a": 1}], "rules": [RULES], "backend": "cpu",
          "tenant": "burst-caller"}
    assert lambda_handler.handler(ev)["code"] == 0
    lambda_handler._SESSION._get_frontdoor().admission = AdmissionController(
        rate=1.0, burst=1.0, max_inflight=0, clock=clk)
    assert lambda_handler.handler(ev)["code"] == 0
    rej = lambda_handler.handler(ev)
    assert rej["code"] == 5
    assert rej["error_class"] == "QuotaExceeded"
    assert rej["retry_after_ms"] == 1000
    monkeypatch.setattr(lambda_handler, "_SESSION", None)


# -- front-door fault points ----------------------------------------------

def test_front_door_fault_points_registered():
    assert "admission" in POINTS
    assert "shed" in POINTS


def test_injected_admission_fault_answers_structured(monkeypatch):
    monkeypatch.setenv("GUARD_TPU_FAULT", "admission:nth=1")
    reset_faults()
    try:
        srv = Serve(stdio=True, device="cpu")
        r1 = srv.handle_line(_req())
        assert r1["code"] == 5
        assert r1["error_class"] == "InjectedFault"
        r2 = srv.handle_line(_req())
        assert r2["code"] == 0
    finally:
        monkeypatch.delenv("GUARD_TPU_FAULT")
        reset_faults()


def test_injected_shed_fault_answers_structured(monkeypatch):
    monkeypatch.setenv("GUARD_TPU_FAULT", "shed:nth=1")
    reset_faults()
    try:
        srv = Serve(stdio=True, coalesce=True, device="cpu")
        srv._batcher = _AlwaysFull()
        resp = srv.handle_line(_req(backend="tpu"))
        assert resp["code"] == 5
        assert resp["error_class"] == "InjectedFault"
    finally:
        monkeypatch.delenv("GUARD_TPU_FAULT")
        reset_faults()
