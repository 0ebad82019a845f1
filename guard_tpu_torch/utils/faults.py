"""Deterministic fault injection for the document quarantine.

The port's copy of guard_tpu/utils/faults.py's grammar and firing
rules. Named injection points are driven by the `GUARD_TPU_FAULT`
environment variable (the JAX package's variable, so one environment
puts both packages in one state) — no wall-clock, no global RNG, so a
failing run replays bit-for-bit.

Grammar (comma-separated clauses)::

    GUARD_TPU_FAULT=<point>:<spec>[,<point>:<spec>...]

where `<point>` is one of POINTS and `<spec>` is one of:

    nth=K            fire on the Kth eligible call in this process
                     (1-based; fires exactly once per process)
    glob=PATTERN     fire whenever the call's key (usually a file
                     name) fnmatches PATTERN (stateless; every match)
    rate=R[:seed=S]  fire pseudo-randomly at rate R in [0,1], keyed by
                     sha256(seed, point, call index, key)

The grammar accepts every point the JAX package names. The port fires
`parse` and `encode` (ops/encoder.encode_chunk_texts, the
--max-doc-failures encode of `validate`), `dispatch` and `collect`
(the degradation ladder of the device path: ops/backend.collect_packs,
parallel/device.evaluate_groups), `oracle` (the inline CPU rerun of
ops/backend._report_files), `store_write` (ops/plan.save_plan,
cache/results.store_entries, per entry) and `cache`
(cache/results.load_entries and store_entries, per entry);
`read` fires where the sweep reads its chunks, which the port does not
have yet, and the JAX package's `validate` does not fire it either.
Every firing counts in `FAULT_COUNTERS["injected_<point>"]`;
`quarantined_docs` counts the documents a run quarantined,
`dispatch_fallbacks` the device dispatches and collects that failed
and were retried lower on the ladder, `oracle_fallbacks` the injected
faults that sent documents to the host oracle (no other failure does).
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
from typing import Optional

from ..core.errors import GuardError
from .telemetry import REGISTRY as _TELEMETRY
from .telemetry import EventedCounters

#: the JAX package's injection points, in pipeline order
POINTS = (
    "read", "parse", "encode", "worker_crash",
    "dispatch", "collect", "oracle", "serve_batch", "cache",
    "admission", "shed", "journal", "store_write",
)

#: firings per point and the recoveries they caused, for this process:
#: the telemetry group "fault", an EventedCounters, so every increment
#: is an instant trace event when tracing is on and arms the flight
#: recorder's abnormal-exit dump
FAULT_COUNTERS = _TELEMETRY.counter_group("fault", EventedCounters("fault", {
    **{f"injected_{p}": 0 for p in POINTS},
    "quarantined_docs": 0,
    "dispatch_fallbacks": 0,
    "oracle_fallbacks": 0,
}))


class InjectedFault(GuardError):
    """Raised at an active injection point; flows through the same
    recovery paths as a real failure of that stage."""


# parsed per env-string: re-parsed whenever GUARD_TPU_FAULT changes, so
# tests can flip it with monkeypatch without a reset hook
_STATE = {"env": None, "specs": {}, "calls": {}, "fired": set()}


def _parse(env: str) -> dict:
    specs: dict = {}
    for clause in env.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        point = parts[0].strip()
        if point not in POINTS:
            raise GuardError(
                f"GUARD_TPU_FAULT: unknown injection point {point!r} "
                f"(expected one of {', '.join(POINTS)})"
            )
        spec: dict = {}
        for kv in parts[1:]:
            if "=" not in kv:
                raise GuardError(
                    f"GUARD_TPU_FAULT: malformed spec {kv!r} in "
                    f"{clause!r} (expected key=value)"
                )
            k, v = kv.split("=", 1)
            k = k.strip()
            if k == "nth":
                try:
                    spec["nth"] = int(v)
                except ValueError:
                    raise GuardError(
                        f"GUARD_TPU_FAULT: nth must be an integer, "
                        f"got {v!r}"
                    )
            elif k == "glob":
                spec["glob"] = v
            elif k == "rate":
                try:
                    spec["rate"] = float(v)
                except ValueError:
                    raise GuardError(
                        f"GUARD_TPU_FAULT: rate must be a float, "
                        f"got {v!r}"
                    )
            elif k == "seed":
                spec["seed"] = v
            else:
                raise GuardError(
                    f"GUARD_TPU_FAULT: unknown spec key {k!r} in "
                    f"{clause!r}"
                )
        if not any(k in spec for k in ("nth", "glob", "rate")):
            raise GuardError(
                f"GUARD_TPU_FAULT: clause {clause!r} needs one of "
                "nth=/glob=/rate="
            )
        specs[point] = spec
    return specs


def _specs() -> dict:
    env = os.environ.get("GUARD_TPU_FAULT", "")
    if env != _STATE["env"]:
        _STATE["env"] = env
        _STATE["specs"] = _parse(env) if env.strip() else {}
        _STATE["calls"] = {}
        _STATE["fired"] = set()
    return _STATE["specs"]


def fault_active(point: str) -> bool:
    """True when GUARD_TPU_FAULT names `point` (a cheap pre-check, so
    clean runs skip the per-call bookkeeping)."""
    return point in _specs()


def should_fire(point: str, key: Optional[str] = None) -> bool:
    spec = _specs().get(point)
    if spec is None:
        return False
    calls = _STATE["calls"]
    calls[point] = calls.get(point, 0) + 1
    if "glob" in spec:
        return key is not None and fnmatch.fnmatch(key, spec["glob"])
    if "nth" in spec:
        if point in _STATE["fired"]:
            return False
        if calls[point] == spec["nth"]:
            _STATE["fired"].add(point)
            return True
        return False
    # seeded rate: deterministic hash of (seed, point, call idx, key)
    seed = spec.get("seed", "0")
    h = hashlib.sha256(
        f"{seed}:{point}:{calls[point]}:{key or ''}".encode()
    ).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64 < spec["rate"]


def maybe_fail(point: str, key: Optional[str] = None) -> None:
    """Raise InjectedFault when `point` is active and its spec fires
    for this call. No-op (and counter-free) otherwise."""
    if should_fire(point, key):
        FAULT_COUNTERS[f"injected_{point}"] += 1
        suffix = f" ({key})" if key else ""
        raise InjectedFault(f"injected {point} fault{suffix}")


def quarantine_record(file: str, stage: str, exc: BaseException) -> dict:
    """The structured error record of a quarantined document."""
    return {
        "file": file,
        "stage": stage,
        "error": type(exc).__name__,
        "message": str(exc),
    }


def fault_stats() -> dict:
    return dict(FAULT_COUNTERS)


def reset_faults() -> None:
    """Counters AND call/fired state (tests: fresh nth= sequencing)."""
    _TELEMETRY.reset_group("fault")
    _STATE.update(env=None, specs={}, calls={}, fired=set())


def dispatch_timeout() -> float:
    """Per-dispatch/collect timeout in seconds (0 = unbounded), from
    `GUARD_TPU_DISPATCH_TIMEOUT`."""
    raw = os.environ.get("GUARD_TPU_DISPATCH_TIMEOUT", "").strip()
    try:
        return float(raw) if raw else 0.0
    except ValueError:
        return 0.0


def bounded_call(fn, *args):
    """Run `fn(*args)` under the configured dispatch timeout. With no
    timeout configured this is a direct call. On timeout the worker
    thread is abandoned (a wedged device call cannot be cancelled, only
    orphaned) and a GuardError is raised so the caller's degradation
    ladder engages."""
    t = dispatch_timeout()
    if t <= 0:
        return fn(*args)
    from concurrent.futures import ThreadPoolExecutor, TimeoutError

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(fn, *args)
        try:
            return fut.result(timeout=t)
        except TimeoutError:
            raise GuardError(f"device call timed out after {t:g}s")
    finally:
        ex.shutdown(wait=False)
