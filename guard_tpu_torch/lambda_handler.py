"""AWS-Lambda-style handler: the serving plane's third deployment face.

The port of the JAX package's guard_tpu/lambda_handler.py.

Two event shapes, discriminated by key:

* **Legacy** (`{"data": "<doc string>", "rules": [...], "verbose":
  bool}`) — cfn-guard's Lambda contract
  (`guard-lambda/src/main.rs:41-66`): each rules string
  validates against the data via `run_checks`, parsed JSON results
  return as `{"message": [...]}`. Byte-identical to the pre-front-door
  handler.

* **Front door** (`{"documents": [...], "rules": [...]}`) — the event
  routes through a module-global `Serve` session: the SAME handler the
  stdio loop, the TCP/HTTP listener and the webhook face share, so a
  warm Lambda container reuses the prepared-rules cache, the plan
  memo, the coalescing batcher AND the traffic discipline (per-tenant
  quotas via `"tenant"`, the SLO circuit breaker, overload shedding).
  Optional keys: `backend` (default "tpu": the card; concurrent
  invocations in one container coalesce into packed dispatches),
  `output_format` (default "sarif"), `tenant`, `verbose`. The session
  has no flags: its tenant default is GUARD_TPU_TENANT_DEFAULT, and it
  runs on the CUDA card (with none, a `tpu` event answers the code-5
  no-card envelope). Returns the serve response
  envelope: `{"code": 0|19|5, "output": ..., "error": ...}` plus
  `error_class`/`retry_after_ms` on structured rejections — an
  over-quota invocation gets the 429-class envelope, never a hang.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List

from .api import run_checks
from .core.errors import GuardError

# one warm Serve session per container (Lambda freezes/thaws the
# process between invocations — module globals persist, so the plan
# memo and batcher amortize across invocations like any serve session)
_SESSION = None
_SESSION_LOCK = threading.Lock()


def _session():
    global _SESSION
    with _SESSION_LOCK:
        if _SESSION is None:
            from .commands.serve import Serve

            _SESSION = Serve(stdio=False)
        return _SESSION


def handler(event: Dict[str, Any], context: Any = None) -> Dict[str, List]:
    if isinstance(event, dict) and "documents" in event:
        return _handle_frontdoor(event)
    data = event.get("data", "")
    rules = event.get("rules", [])
    verbose = bool(event.get("verbose", False))
    results = []
    for each_rule in rules:
        try:
            out = run_checks(data, each_rule, verbose)
        except GuardError as e:
            raise ValueError(str(e))
        results.append(json.loads(out) if out else None)
    return {"message": results}


def _handle_frontdoor(event: Dict[str, Any]) -> Dict[str, Any]:
    """One invocation through the shared serve handler. Documents may
    be strings (raw JSON/YAML text) or objects (serialized here)."""
    docs = [
        d if isinstance(d, str) else json.dumps(d)
        for d in event.get("documents", [])
    ]
    req: Dict[str, Any] = {
        "rules": event.get("rules", []),
        "data": docs,
        "backend": event.get("backend", "tpu"),
        "output_format": event.get("output_format", "sarif"),
    }
    if event.get("verbose"):
        req["verbose"] = True
    if event.get("tenant"):
        req["tenant"] = event["tenant"]
    return _session().handle_line(json.dumps(req))
