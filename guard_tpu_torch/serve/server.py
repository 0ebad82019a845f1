"""Threaded TCP/HTTP listener for the serving plane (`--listen`).

A copy of the JAX package's guard_tpu/serve/server.py; the device work
happens behind `Serve.handle_line` (commands/serve.py). One difference,
the drain: the listener stops accepting, then accepts the connections
the kernel had already queued (the session answers them Draining), and
waits (bounded by GUARD_TPU_DRAIN_TIMEOUT_MS) for every connection it
is answering before the session exits, so a client that connected
before the stop gets its reply instead of a reset.

One process, many clients: each accepted connection gets a handler
thread that speaks either of two protocols, sniffed from the first
bytes —

* **JSONL** (the stdio protocol over a socket): newline-delimited JSON
  requests, one JSON response line per request, identical envelopes to
  `serve --stdio`. Requests tagged with an `"id"` are answered with
  the id echoed (responses may interleave across a connection's
  pipelined requests exactly as the multiplexed stdio session does).
* **HTTP/1.1** (curl-able face): `POST /validate` with a JSON request
  body returns the response envelope as `application/json`;
  `GET /metrics` returns the live telemetry snapshot;
  `POST /webhook` is the Kubernetes ValidatingWebhook face
  (AdmissionReview in, allowed/denied + per-rule messages out,
  evaluated against the session's `--rules` registry). Minimal by
  design — one request per connection, no keep-alive.

Input discipline (the front door's transport leg): bodies and JSONL
lines are capped at `GUARD_TPU_SERVE_MAX_BODY` bytes — an oversized
HTTP body answers a structured 413 WITHOUT reading the payload, an
oversized JSONL line answers a structured error envelope; per-tenant
quota rejections and a saturated admission queue map to HTTP 429
(with a Retry-After hint) or the same structured JSONL envelope —
the accept loop never blocks on traffic it will not serve. The
connection-default tenant comes from the `X-Guard-Tenant` header.

Every connection shares the session's `Serve` instance, so the
prepared-rules cache, the process-global plan memo and the coalescing
batcher amortize across clients — sixteen connections asking about one
registry fill one packed dispatch (serve/batcher.py).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Optional

from ..utils.io import Writer
from . import frontdoor


#: the listen backlog: at most this many connections wait in the
#: kernel's accept queue, and a drain accepts at most this many
_BACKLOG = 64


def _parse_hostport(listen: str) -> tuple:
    """`HOST:PORT` (port 0 = OS-assigned); bare `PORT` binds localhost."""
    if ":" in listen:
        host, _, port = listen.rpartition(":")
        return host or "127.0.0.1", int(port)
    return "127.0.0.1", int(listen)


class ServeServer:
    """Accept loop + per-connection handler threads over one shared
    `Serve` session. `start()` binds and returns (port available as
    `.port` — bind with :0 in tests); `serve_forever()` blocks until
    `stop()` or KeyboardInterrupt."""

    def __init__(self, serve, listen: str):
        self.serve = serve
        self.host, self.port = _parse_hostport(listen)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # connection handler threads still running (wait_idle)
        self._handlers: set = set()
        self._handlers_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "ServeServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(_BACKLOG)
        # the accept loop polls _stopped, so a drain can take over the
        # accept queue once the loop has returned (stop(drain=True))
        s.settimeout(0.1)
        self.port = s.getsockname()[1]
        self._sock = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="guard-tpu-accept"
        )
        self._accept_thread.start()
        return self

    def stop(self, drain: bool = False) -> None:
        """Stop accepting and close the socket. With `drain`, first wait
        for the accept loop to return, then accept the connections the
        kernel already queued (closing the socket would reset them), at
        most a backlog's worth, so clients that keep connecting cannot
        hold the drain open."""
        self._stopped.set()
        if self._sock is None:
            return
        if drain:
            if self._accept_thread is not None:
                self._accept_thread.join(5)
            self._sock.setblocking(False)
            for _ in range(_BACKLOG):
                try:
                    conn, _addr = self._sock.accept()
                except OSError:
                    break
                conn.setblocking(True)
                self._spawn(conn)
        try:
            self._sock.close()
        except OSError:
            pass

    def wait_idle(self, timeout: float) -> bool:
        """Join the connection handlers still running, bounded by
        `timeout` seconds in all; True when none is left."""
        import time

        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            with self._handlers_lock:
                pending = list(self._handlers)
            if not pending:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            pending[0].join(remaining)

    def serve_forever(self) -> int:
        if self._sock is None:
            self.start()
        try:
            self._stopped.wait()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
        return 0

    # -- connection handling ------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed by stop()
            # the listening socket's timeout is not the connection's
            conn.setblocking(True)
            self._spawn(conn)

    def _spawn(self, conn: socket.socket) -> None:
        t = threading.Thread(
            target=self._handle_conn, args=(conn,), daemon=True,
            name="guard-tpu-conn",
        )
        with self._handlers_lock:
            self._handlers.add(t)
        t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            self._handle_conn_inner(conn)
        finally:
            with self._handlers_lock:
                self._handlers.discard(threading.current_thread())

    def _handle_conn_inner(self, conn: socket.socket) -> None:
        try:
            f = conn.makefile("rwb")
            first = f.peek(8)[:8] if hasattr(f, "peek") else b""
            if first.split(b" ", 1)[0] in (b"POST", b"GET", b"PUT", b"HEAD"):
                self._handle_http(f)
            else:
                self._handle_jsonl(f)
        except (OSError, ValueError):
            pass  # client went away mid-request
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_jsonl(self, f) -> None:
        """The stdio protocol over a socket, ids multiplexed exactly
        like the stdio session: untagged requests answer in order,
        tagged ones may coalesce with peers from other connections."""
        wlock = threading.Lock()
        pending = []
        cap = frontdoor.max_body_bytes()
        for raw in f:
            if cap and len(raw) > cap:
                # oversized line: structured 413-class envelope, no
                # parse attempt (the line is already drained off the
                # socket — a line protocol cannot refuse mid-line)
                frontdoor.ADMISSION_COUNTERS["rejected_body_size"] += 1
                with wlock:
                    f.write((json.dumps({
                        "code": 5, "output": "",
                        "error": f"request line exceeds "
                                 f"GUARD_TPU_SERVE_MAX_BODY ({cap}B)",
                        "error_class": "BodyTooLarge",
                    }) + "\n").encode())
                    f.flush()
                continue
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                break
            rid = self.serve.request_id(line)

            def _answer(line=line, rid=rid):
                resp = self.serve.handle_line(line)
                if rid is not None:
                    resp["id"] = rid
                with wlock:
                    f.write((json.dumps(resp) + "\n").encode())
                    f.flush()

            if rid is None:
                _answer()
            else:
                t = threading.Thread(target=_answer, daemon=True)
                t.start()
                pending.append(t)
        for t in pending:
            t.join()

    def _handle_http(self, f) -> None:
        request_line = f.readline().decode("latin-1").strip()
        parts = request_line.split(" ")
        if len(parts) < 2:
            return
        method, path = parts[0], parts[1]
        clen = 0
        headers = {}
        while True:
            h = f.readline().decode("latin-1").strip()
            if not h:
                break
            k, _, v = h.partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            clen = int(headers.get("content-length", "0"))
        except ValueError:
            clen = 0
        # connection-default tenant: the header names it; the request
        # envelope's own "tenant" field still wins
        tenant = headers.get("x-guard-tenant") or None
        cap = frontdoor.max_body_bytes()
        if method == "POST" and cap and clen > cap:
            # 413 BEFORE reading the body — an oversized payload never
            # ties up the handler thread
            frontdoor.ADMISSION_COUNTERS["rejected_body_size"] += 1
            self._http_reply(f, 413, json.dumps({
                "code": 5, "output": "",
                "error": f"body of {clen}B exceeds "
                         f"GUARD_TPU_SERVE_MAX_BODY ({cap}B)",
                "error_class": "BodyTooLarge",
            }))
            return
        if method == "GET" and path == "/metrics":
            body = json.dumps(self.serve.handle_line('{"metrics": true}'))
            self._http_reply(f, 200, body)
            return
        if method == "POST" and path == "/webhook":
            payload = f.read(clen).decode("utf-8", "replace") if clen else ""
            status, doc = self.serve.handle_webhook(payload, tenant)
            extra = {}
            if status == 429:
                extra["Retry-After"] = str(
                    max(1, doc.get("retry_after_ms", 1000) // 1000)
                )
            self._http_reply(f, status, json.dumps(doc), extra)
            return
        if method == "POST":
            payload = f.read(clen).decode("utf-8", "replace") if clen else ""
            resp = self.serve.handle_line(
                payload.strip() or "{}", default_tenant=tenant
            )
            err_class = resp.get("error_class")
            if err_class in ("QuotaExceeded", "QueueFull"):
                # traffic discipline speaks HTTP: quota and saturation
                # are 429s with a Retry-After hint, not generic 422s
                self._http_reply(
                    f, 429, json.dumps(resp),
                    {"Retry-After": str(
                        max(1, resp.get("retry_after_ms", 1000) // 1000)
                    )},
                )
                return
            code = 200 if err_class is None else 422
            self._http_reply(f, code, json.dumps(resp))
            return
        self._http_reply(f, 404, json.dumps({"error": "not found"}))

    @staticmethod
    def _http_reply(f, status: int, body: str,
                    extra_headers: Optional[dict] = None) -> None:
        reason = {
            200: "OK", 404: "Not Found", 413: "Payload Too Large",
            422: "Unprocessable Entity", 429: "Too Many Requests",
        }
        data = body.encode()
        extras = "".join(
            f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
        )
        head = (
            f"HTTP/1.1 {status} {reason.get(status, 'OK')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"{extras}"
            f"Connection: close\r\n\r\n"
        )
        f.write(head.encode("latin-1") + data)
        f.flush()


def run_listener(serve, listen: str, writer: Writer) -> int:
    """CLI entry: bind, announce the bound address on stderr (port 0
    resolves here), then serve until interrupted. With a drain latch on
    the session (commands/serve.py installs one), a SIGTERM/SIGINT trip
    stops the accept loop; the caller finishes in-flight batches and
    maps the trip to the drain exit code."""
    server = ServeServer(serve, listen).start()
    writer.writeln_err(
        f"guard-tpu serve: listening on {server.host}:{server.port}"
    )
    latch = getattr(serve, "drain_latch", None)
    if latch is None:
        return server.serve_forever()
    try:
        while not server._stopped.is_set() and not latch.tripped():
            latch.wait(0.1)
    except KeyboardInterrupt:
        latch.trip("SIGINT")
    finally:
        server.stop(drain=latch.tripped())
        if latch.tripped():
            from ..utils.journal import drain_timeout_s

            # the requests in flight finish their replies (a request
            # that reaches the session now answers the Draining
            # envelope); the batcher drains after this returns
            server.wait_idle(drain_timeout_s())
    return 0
