"""The port's concurrent serving plane (guard_tpu_torch/serve/) against
the JAX package's, on the CPU.

The cases of tests/test_serve_concurrent.py, with their
parametrizations: threads replaying a request mix against one
coalescing session of the port (`device="cpu"`) must answer, request
by request, the bytes (code, output, error, error_class) of the JAX
package's sequential session (GUARD_TPU_COALESCE=0) and of the port's
(`coalesce=False`), across packed and per-file dispatch and ingest
settings, with a poisoned request per batch, two digests in flight and
an injected `serve_batch` fault; coalescing issues fewer dispatches than
requests; tagged stdio requests multiplex; the TCP/HTTP listener
answers the same envelopes. Then `ops.backend.tpu_validate_multi` over
all 249 corpus rule files: three payload requests of 1, 5 and 17
corpus inputs (one document routed to the host oracle) in one batch,
each segment the bytes of its own sequential run in both packages.

No assertion depends on wall-clock coalescing: a barrier releases the
threads together and the window is at least 100 ms; batch counts are
asserted only as fewer dispatches than requests. Every socket, join and
wait is bounded.
"""

import json
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

from guard_tpu_torch.commands.serve import Serve
from guard_tpu_torch.utils import telemetry
from guard_tpu_torch.utils.io import Reader, Writer
from test_torch_ingest import set_encoders

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 120

RULES = [
    "rule has_a { a exists }\nrule b_is_one { b == 1 }",
    "rule c_small { c < 10 }",
]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_COALESCE", "GUARD_TPU_COALESCE_WAIT_MS",
                 "GUARD_TPU_SERVE_TIMEOUT", "GUARD_TPU_SERVE_ABANDONED_MAX",
                 "GUARD_TPU_SERVE_SLO_MS", "GUARD_TPU_TENANT_RATE", "GUARD_TPU_PACK",
                 "GUARD_TPU_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)


def _req(i, poisoned=False, rules=None, **extra):
    data = [
        json.dumps({"a": i, "b": 1, "c": i % 7}),
        json.dumps({"a": i + 1, "b": 1, "c": 3}),
    ]
    if poisoned:
        data[0] = '{"a": '  # truncated JSON: load_document raises
    body = {"rules": RULES if rules is None else rules, "data": data, "backend": "tpu",
            **extra}
    return json.dumps(body)


def _envelope(resp):
    return (resp["code"], resp.get("output"), resp.get("error"), resp.get("error_class"))


def jax_sequential(monkeypatch, lines):
    """The JAX package's baseline: one request at a time, coalescing off."""
    from guard_tpu.commands.serve import Serve as JaxServe

    monkeypatch.setenv("GUARD_TPU_COALESCE", "0")
    try:
        srv = JaxServe(stdio=True)
        return [_envelope(srv.handle_line(ln)) for ln in lines]
    finally:
        monkeypatch.delenv("GUARD_TPU_COALESCE")


def port_sequential(lines):
    srv = Serve(stdio=True, coalesce=False, device="cpu")
    return [_envelope(srv.handle_line(ln)) for ln in lines]


def run_threads(target, n):
    """`n` threads released together by a barrier, each joined bounded."""
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait(JOIN_S)
        target(i)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a request thread did not finish"


def port_concurrent(lines, srv=None):
    """N threads against one coalescing session of the port."""
    srv = srv or Serve(stdio=True, coalesce=True, device="cpu")
    results = [None] * len(lines)

    def one(i):
        results[i] = _envelope(srv.handle_line(lines[i]))

    run_threads(one, len(lines))
    return results


def patch_no_pack(monkeypatch):
    """The port's Validate with packing off, as GUARD_TPU_PACK=0 sets it
    in the JAX package (the port has no environment twin)."""
    from guard_tpu_torch.commands import validate as validate_mod

    class NoPack(validate_mod.Validate):
        def __init__(self, *a, **kw):
            super().__init__(*a, pack_rules=False, **kw)

    monkeypatch.setattr(validate_mod, "Validate", NoPack)


@pytest.mark.parametrize("pack", ["0", "1"])
@pytest.mark.parametrize("workers", ["0", "2"])
def test_concurrent_parity_with_poisoned_peer(monkeypatch, pack, workers):
    """Byte parity across dispatch modes with one poisoned request: its
    error envelope reproduces and its batch peers still answer."""
    monkeypatch.setenv("GUARD_TPU_PACK", pack)
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", workers)
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    lines = [_req(i, poisoned=(i == 3)) for i in range(8)]
    want = jax_sequential(monkeypatch, lines)
    if pack == "0":
        patch_no_pack(monkeypatch)
    assert port_sequential(lines) == want
    assert port_concurrent(lines) == want
    assert want[3][0] == 5 and want[3][3] == "ParseError"
    assert all(want[i][0] == 0 for i in range(8) if i != 3)


@pytest.mark.parametrize("out_fmt", ["sarif", "json"])
def test_concurrent_parity_output_formats(monkeypatch, out_fmt):
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    lines = [_req(i, output_format=out_fmt) for i in range(6)]
    assert port_concurrent(lines) == jax_sequential(monkeypatch, lines)


def test_concurrent_mixed_digests_group_separately(monkeypatch):
    """Two registries in flight, over one shared plan memo: each
    coalesces in its own digest group, and every answer is its own."""
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    alt = ["rule alt { z exists }"]
    lines = [_req(i, rules=(alt if i % 2 else None), poisoned=(i == 5)) for i in range(8)]
    assert port_concurrent(lines) == jax_sequential(monkeypatch, lines)


def test_coalescing_reduces_dispatches(monkeypatch):
    """16 concurrent requests on one rule digest: fewer device
    dispatches than requests, the same bytes, seen in the serve
    counters."""
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "300")
    lines = [_req(i) for i in range(16)]
    want = jax_sequential(monkeypatch, lines)

    telemetry.REGISTRY.reset()
    assert port_sequential(lines) == want
    seq_dispatches = DISPATCH_COUNTERS["dispatches"]

    telemetry.REGISTRY.reset()
    assert port_concurrent(lines) == want
    con_dispatches = DISPATCH_COUNTERS["dispatches"]
    assert seq_dispatches >= 16
    assert con_dispatches < len(lines)
    assert SERVE_COUNTERS["coalesced_batches"] >= 1
    assert SERVE_COUNTERS["coalesced_requests"] >= 2


def test_adaptive_window_skips_for_lone_request(monkeypatch):
    """A request admitted to an empty queue dispatches at once (the
    formation wait is skipped and counted), with the same bytes."""
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "300")
    lines = [_req(0)]
    want = jax_sequential(monkeypatch, lines)
    telemetry.REGISTRY.reset()
    srv = Serve(stdio=True, coalesce=True, device="cpu")
    t0 = time.monotonic()
    got = [_envelope(srv.handle_line(lines[0]))]
    elapsed = time.monotonic() - t0
    assert got == want
    assert SERVE_COUNTERS["coalesce_window_adaptive"] >= 1
    assert elapsed < 0.25  # far under the 300 ms window


def test_injected_serve_batch_fault_refires_solo(monkeypatch):
    """An injected serve_batch fault quarantines the BATCH: every member
    re-fires solo and answers the sequential bytes."""
    from guard_tpu_torch.utils import faults
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    lines = [_req(i) for i in range(4)]
    want = jax_sequential(monkeypatch, lines)
    faults.reset_faults()
    monkeypatch.setenv("GUARD_TPU_FAULT", "serve_batch:nth=1")
    telemetry.REGISTRY.reset()
    try:
        got = port_concurrent(lines)
    finally:
        monkeypatch.delenv("GUARD_TPU_FAULT")
        refires = SERVE_COUNTERS["isolation_refires"]
        injected = faults.FAULT_COUNTERS["injected_serve_batch"]
        faults.reset_faults()
    assert got == want
    assert injected == 1
    assert refires >= 1


def test_failed_shared_phase_refires_solo(monkeypatch):
    """A shared phase that raises (as a kernel or CUDA error would)
    re-fires every member solo: each answers alone, and the batch's
    failure reaches no member."""
    from guard_tpu_torch.ops import backend
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    lines = [_req(i) for i in range(4)]
    want = jax_sequential(monkeypatch, lines)

    def broken(requests):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(backend, "tpu_validate_multi", broken)
    telemetry.REGISTRY.reset()
    assert port_concurrent(lines) == want
    assert SERVE_COUNTERS["isolation_refires"] >= 2


def test_stress_three_digests_more_threads_than_cores(monkeypatch):
    """More request threads than cores, a short switch interval, three
    registries sharing the plan memo and one poisoned request per
    registry: every answer is its sequential bytes, every request gets
    exactly one, and the session's rules cache holds each registry
    once."""
    import os
    import sys

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "100")
    registries = [None, ["rule alt { z exists }"], ["rule d { c > 2 }\nrule e { a exists }"]]
    n = max(24, 3 * (os.cpu_count() or 1))
    lines = [_req(i, rules=registries[i % 3], poisoned=(i < 3)) for i in range(n)]
    want = jax_sequential(monkeypatch, lines)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv = Serve(stdio=True, coalesce=True, device="cpu")
        got = port_concurrent(lines, srv)
    finally:
        sys.setswitchinterval(interval)
    assert got == want
    assert [w[3] for w in want[:3]] == ["ParseError"] * 3
    assert len(srv._rules_cache) == 3


def test_stdio_session_multiplexes_tagged_requests(monkeypatch):
    """`"id"`-tagged requests over one stdio session: every response
    carries its id and the sequential envelope."""
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "100")
    lines = [_req(i, id=f"r{i}") for i in range(6)]
    want = jax_sequential(monkeypatch, [_req(i) for i in range(6)])
    w = Writer.buffered()
    rc = Serve(stdio=True, device="cpu").execute(w, Reader.from_string("\n".join(lines) + "\n"))
    assert rc == 0
    resps = {r["id"]: r for r in (json.loads(ln) for ln in w.out.getvalue().splitlines() if ln)}
    assert set(resps) == {f"r{i}" for i in range(6)}
    for i in range(6):
        assert _envelope(resps[f"r{i}"]) == want[i]


def test_untagged_stdio_session_stays_in_order(monkeypatch):
    """Untagged requests keep the strictly ordered protocol."""
    lines = [_req(i) for i in range(3)]
    want = jax_sequential(monkeypatch, lines)
    w = Writer.buffered()
    rc = Serve(stdio=True, device="cpu").execute(w, Reader.from_string("\n".join(lines) + "\n"))
    assert rc == 0
    got = [json.loads(ln) for ln in w.out.getvalue().splitlines() if ln]
    assert [_envelope(r) for r in got] == want
    assert all("id" not in r for r in got)


def test_tcp_listener_serves_jsonl_clients(monkeypatch):
    """Two TCP clients against one listener: the sequential envelopes,
    ids echoed."""
    from guard_tpu_torch.serve.server import ServeServer

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "100")
    lines = [_req(i) for i in range(4)]
    want = jax_sequential(monkeypatch, lines)
    srv = Serve(stdio=False, coalesce=True, device="cpu")
    server = ServeServer(srv, "127.0.0.1:0").start()
    results = {}
    try:
        def client(idx):
            with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
                f = s.makefile("rwb")
                for i in range(idx, 4, 2):
                    tagged = json.loads(lines[i])
                    tagged["id"] = i
                    f.write((json.dumps(tagged) + "\n").encode())
                f.flush()
                s.shutdown(socket.SHUT_WR)
                for r in (json.loads(ln) for ln in f if ln.strip()):
                    results[r["id"]] = r

        run_threads(client, 2)
    finally:
        server.stop()
    assert set(results) == {0, 1, 2, 3}
    for i in range(4):
        assert _envelope(results[i]) == want[i]


def test_http_listener_answers_post_and_metrics(monkeypatch):
    """POST /validate returns the envelope (the JAX package's bytes),
    GET /metrics the live snapshot."""
    import http.client

    from guard_tpu_torch.serve.server import ServeServer

    want = jax_sequential(monkeypatch, [_req(1)])[0]
    server = ServeServer(Serve(stdio=False, device="cpu"), "127.0.0.1:0").start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("POST", "/validate", body=_req(1),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert _envelope(body) == want and body["code"] == 0

        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        snap = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert snap["metrics"]["schema_version"] == telemetry.SCHEMA_VERSION
    finally:
        server.stop()


def test_metrics_survive_concurrency_without_reset(monkeypatch):
    """No per-request global reset: cumulative counters grow across
    concurrent requests, and the metrics envelope carries a
    last_request diff and the dispatch histogram of coalesced
    batches."""
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    telemetry.REGISTRY.reset(include_persistent=True)
    srv = Serve(stdio=True, coalesce=True, device="cpu")
    lines = [_req(i) for i in range(6)]
    run_threads(lambda i: srv.handle_line(lines[i]), 6)
    m = srv.handle_line(json.dumps({"metrics": True}))
    snap = m["metrics"]
    assert snap["counters"]["serve"]["requests"] == 6
    assert snap["histograms"]["serve_request_seconds"]["count"] == 6
    assert snap["histograms"]["serve_queue_wait_seconds"]["count"] == 6
    if snap["counters"]["serve"]["coalesced_batches"]:
        assert snap["histograms"]["serve_dispatch_seconds"]["count"] >= 1
    assert isinstance(m["last_request"], dict)
    telemetry.REGISTRY.reset(include_persistent=True)


def test_abandoned_thread_cap(monkeypatch):
    """Past GUARD_TPU_SERVE_ABANDONED_MAX the session stops abandoning
    executors, keeps answering RequestTimeout, and the abandoned count
    rides the gauge."""
    from guard_tpu_torch.commands import validate as validate_mod
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    def slow_execute(self, writer, reader):
        time.sleep(0.6)
        return 0

    monkeypatch.setattr(validate_mod.Validate, "execute", slow_execute)
    monkeypatch.setenv("GUARD_TPU_SERVE_TIMEOUT", "0.05")
    monkeypatch.setenv("GUARD_TPU_SERVE_ABANDONED_MAX", "1")
    telemetry.REGISTRY.reset()
    srv = Serve(stdio=True, coalesce=False, device="cpu")
    r1 = srv.handle_line(_req(0))
    assert r1["error_class"] == "RequestTimeout"
    assert srv._abandoned == 1
    r2 = srv.handle_line(_req(1))
    assert r2["error_class"] == "RequestTimeout"
    assert srv._abandoned == 1  # the cap held
    assert SERVE_COUNTERS["abandoned_threads"] == 1
    assert srv._abandoned_warned


def test_rules_cache_stays_bounded_with_gauge(monkeypatch):
    """The prepared-rules cache evicts LRU past its ceiling and exports
    its size as a gauge."""
    from guard_tpu_torch.commands.serve import _RULES_CACHE_MAX

    srv = Serve(stdio=True, coalesce=False, device="cpu")
    for i in range(_RULES_CACHE_MAX + 4):
        srv.handle_line(json.dumps({"rules": [f"rule r{i} {{ a exists }}"],
                                    "data": ['{"a": 1}'], "backend": "cpu"}))
    assert len(srv._rules_cache) == _RULES_CACHE_MAX
    assert telemetry.metrics_snapshot()["gauges"]["serve_rules_cache_size"] == _RULES_CACHE_MAX


# -- tpu_validate_multi over the 249-file corpus registry ---------------

def corpus_registry():
    """The 249 corpus rule texts and the corpus's test inputs, in order."""
    rules, inputs = [], []
    corpus = ROOT / "corpus" / "rules"
    for p in sorted(corpus.glob("*.guard")):
        rules.append(p.read_text())
        spec = corpus / "tests" / f"{p.stem}_tests.yaml"
        if spec.exists():
            inputs += [case["input"] for case in yaml.safe_load(spec.read_text()) or []
                       if isinstance(case, dict) and "input" in case]
    return rules, inputs


def registry_requests(out_fmt):
    """Three payload request lines of 1, 5 and 17 corpus inputs drawn
    with a seed; the second request's third document carries an integer
    beyond 64 bits, which routes it to the host oracle."""
    rules, inputs = corpus_registry()
    assert len(rules) == 249 and len(inputs) == 725
    rng = np.random.default_rng(14)
    picks = rng.choice(len(inputs), size=23, replace=False)
    docs = [json.dumps(inputs[i]) if not isinstance(inputs[i], str) else inputs[i]
            for i in picks]
    exotic = inputs[picks[3]] if isinstance(inputs[picks[3]], dict) else {}
    docs[3] = json.dumps({**exotic, "exotic": 2 ** 70})
    segments = (docs[:1], docs[1:6], docs[6:23])
    return rules, [json.dumps({"rules": rules, "data": seg, "backend": "tpu",
                               "output_format": out_fmt}) for seg in segments]


@pytest.mark.parametrize("out_fmt", ["sarif", "json"])
def test_tpu_validate_multi_registry_segments(monkeypatch, out_fmt):
    """One batch of three requests over all 249 corpus files: each
    segment's report is the bytes of its own sequential run, in the port
    and in the JAX package; the shared phase ran once (one packed
    dispatch per bucket for all three), and coalesced serve answers the
    same."""
    from guard_tpu_torch.commands.validate import Validate, payload_inputs
    from guard_tpu_torch.ops.backend import tpu_validate_multi
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS

    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    rules, lines = registry_requests(out_fmt)
    want = jax_sequential(monkeypatch, lines)
    assert port_sequential(lines) == want
    assert [w[0] for w in want] != [5, 5, 5]

    srv = Serve(stdio=True, coalesce=True, device="cpu")
    prepared = srv._prepared_rules(rules)
    reqs = []
    for line in lines:
        cmd = Validate(payload=True, structured=True, output_format=out_fmt,
                       show_summary=["none"], backend="tpu", prepared_rules=prepared,
                       device="cpu")
        w = Writer.buffered()
        rule_files, data_files, _errs = payload_inputs(line, w, prepared)
        reqs.append((cmd, rule_files, data_files, w))
    telemetry.REGISTRY.reset()
    outcomes = tpu_validate_multi(reqs)
    multi_dispatches = DISPATCH_COUNTERS["dispatches"]
    got = [(code, w.out.getvalue(), w.err.getvalue(), None)
           for code, (_c, _r, _d, w) in zip(outcomes, reqs)]
    assert got == want
    views = [cmd.last_evaluation for cmd, *_ in reqs]
    assert [v.n_docs for v in views] == [1, 5, 17]
    assert sum(len(fr.host_docs) for fr in views[1].files) >= 1  # the exotic document
    assert all(not fr.host_docs for v in (views[0], views[2]) for fr in v.files)
    telemetry.REGISTRY.reset()
    port_sequential(lines)
    assert multi_dispatches < DISPATCH_COUNTERS["dispatches"]

    assert port_concurrent(lines, srv) == want
