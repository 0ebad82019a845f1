"""Persistent run ledger: the cross-run memory of the telemetry plane.

The port's copy of guard_tpu/utils/ledger.py. `utils/telemetry.py`
makes a single run observable; every snapshot still dies with the
process. The ledger is an append-only JSONL file
(`$GUARD_TPU_LEDGER_DIR/ledger.jsonl`) of schema-versioned records, one
per `validate` or `sweep` session (cli.run's epilogue), each carrying
the config hash, the port's version, the device census, a headline
(the session's seconds) and the full metrics snapshot (counter groups,
histograms, span roll-ups, plan-cache stats). `backfill` appends one
`bench` record per metric row of bench artifacts (`bench_all_r*.json`).

Opt-in by construction: nothing is written unless GUARD_TPU_LEDGER_DIR
is set, so ordinary CLI use and the test suite stay side-effect-free.

Consumers: `report` (commands/ops_report.py) diffs the two newest
records or a run against a committed baseline ledger;
`regression_check` is its min-of-N noise-band gate (`report --check`).
The record layout is the JAX package's, so either package's `report`
reads either package's ledger.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import sys
import time
from typing import List, Optional

from .telemetry import metrics_snapshot

log = logging.getLogger("guard_tpu_torch.ledger")

#: ledger-record schema version (bump on breaking record-shape changes)
LEDGER_SCHEMA_VERSION = 1

#: record kinds the ledger understands (check_record pins these)
RECORD_KINDS = ("validate", "sweep", "serve", "bench")

#: keys every ledger record must carry
RECORD_KEYS = (
    "schema_version", "kind", "ts", "guard_tpu_version", "config_hash",
    "device_census", "headline", "exit_code", "metrics", "extra",
)


def ledger_dir() -> Optional[str]:
    return os.environ.get("GUARD_TPU_LEDGER_DIR") or None


def ledger_enabled() -> bool:
    return ledger_dir() is not None


def ledger_path() -> Optional[str]:
    d = ledger_dir()
    return os.path.join(d, "ledger.jsonl") if d else None


def config_hash(config) -> str:
    """Stable short digest of a JSON-serializable config mapping: two
    sessions with identical flags hash identically regardless of key
    order (canonical JSON), so `report` can tell "same config, slower"
    from "different config"."""
    canon = json.dumps(config, sort_keys=True, separators=(",", ":"),
                       default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def device_census() -> dict:
    """Backend + device count for the record. Reads torch ONLY if it is
    already imported: a session that never touched the device
    (`--backend cpu`) must not pay for CUDA initialization just to
    write a ledger line."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {"backend": "none", "device_count": 0}
    try:
        if torch.cuda.is_available():
            return {"backend": "cuda", "device_count": torch.cuda.device_count()}
        return {"backend": "cpu", "device_count": 1}
    except Exception:  # a broken CUDA installation must not cost the record
        return {"backend": "unknown", "device_count": 0}


def build_record(kind: str, headline: Optional[dict] = None,
                 config=None, exit_code: Optional[int] = None,
                 extra: Optional[dict] = None,
                 ts: Optional[float] = None,
                 capture_metrics: bool = True) -> dict:
    """Assemble one schema-versioned ledger record (no I/O). `headline`
    is {"metric", "value", "unit"}; `capture_metrics=False` (backfill)
    records `metrics: null` instead of the live snapshot."""
    from .. import __version__ as version

    return {
        "schema_version": LEDGER_SCHEMA_VERSION,
        "kind": kind,
        "ts": time.time() if ts is None else ts,
        "guard_tpu_version": version,
        "config_hash": config_hash(config) if config is not None else None,
        "device_census": device_census(),
        "headline": headline,
        "exit_code": exit_code,
        "metrics": metrics_snapshot() if capture_metrics else None,
        "extra": extra or {},
    }


def append_record(kind: str, headline: Optional[dict] = None,
                  config=None, exit_code: Optional[int] = None,
                  extra: Optional[dict] = None,
                  ts: Optional[float] = None,
                  capture_metrics: bool = True,
                  path: Optional[str] = None) -> Optional[dict]:
    """Append one record to the ledger (creating the directory/file on
    first use). Returns the record, or None when no ledger is
    configured and no explicit path given."""
    if path is None:
        path = ledger_path()
        if path is None:
            return None
    rec = build_record(kind, headline=headline, config=config,
                       exit_code=exit_code, extra=extra, ts=ts,
                       capture_metrics=capture_metrics)
    try:
        from .faults import maybe_fail

        maybe_fail("store_write", key=os.path.basename(path))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # NO sort_keys: the embedded metrics snapshot's histogram-
        # bucket order is schema-relevant (ascending exponents; lexical
        # sorting scrambles "le_2^-7s" vs "le_2^-10s"); record-level
        # canonicality is config_hash's job, not the storage line's
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except Exception as e:  # ENOSPC or an unwritable store:
        # cross-run memory is advisory; losing one record must never
        # change the session's exit code
        log.warning("ledger append failed (%s); record dropped", e)
        return None
    return rec


def read_ledger(path: Optional[str] = None) -> List[dict]:
    """All records of a ledger file, in append order. Raises
    FileNotFoundError for a missing ledger and ValueError (with the
    line number) for a corrupt line — an append-only log that fails to
    parse is a bug worth surfacing, not skipping."""
    if path is None:
        path = ledger_path()
        if path is None:
            raise FileNotFoundError(
                "no ledger configured (set GUARD_TPU_LEDGER_DIR)"
            )
    records = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: corrupt ledger line ({e})")
    return records


def check_record(rec) -> List[str]:
    """Schema validation for one record; returns problem strings
    (empty = valid). The machine face of the record contract: tests
    round-trip through this, and `report` refuses malformed input."""
    problems = []
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    for k in RECORD_KEYS:
        if k not in rec:
            problems.append(f"missing key {k!r}")
    if problems:
        return problems
    if rec["schema_version"] != LEDGER_SCHEMA_VERSION:
        problems.append(
            f"schema_version {rec['schema_version']!r} != "
            f"{LEDGER_SCHEMA_VERSION}"
        )
    if rec["kind"] not in RECORD_KINDS:
        problems.append(f"unknown kind {rec['kind']!r}")
    if not isinstance(rec["ts"], (int, float)):
        problems.append("ts is not numeric")
    census = rec["device_census"]
    if (not isinstance(census, dict) or "backend" not in census
            or "device_count" not in census):
        problems.append("device_census must carry backend + device_count")
    head = rec["headline"]
    if head is not None:
        if (not isinstance(head, dict)
                or not isinstance(head.get("metric"), str)
                or not isinstance(head.get("value"), (int, float))
                or not isinstance(head.get("unit"), str)):
            problems.append(
                "headline must be null or {metric: str, value: number, "
                "unit: str}"
            )
    if rec["metrics"] is not None and not isinstance(rec["metrics"], dict):
        problems.append("metrics must be null or a snapshot object")
    if not isinstance(rec["extra"], dict):
        problems.append("extra is not an object")
    return problems


def _counter_flat(rec: dict) -> dict:
    """{group.key: value} for a record's counter groups (empty when
    metrics were not captured)."""
    out = {}
    metrics = rec.get("metrics") or {}
    for g, vals in (metrics.get("counters") or {}).items():
        if isinstance(vals, dict):
            for k, v in vals.items():
                out[f"{g}.{k}"] = v
    return out


def diff_records(a: dict, b: dict) -> dict:
    """Structured diff of two records (a = older, b = newer): headline
    ratio when both carry comparable headlines, plus every counter
    whose value changed."""
    diff = {
        "a": {"kind": a.get("kind"), "ts": a.get("ts"),
              "config_hash": a.get("config_hash"),
              "headline": a.get("headline")},
        "b": {"kind": b.get("kind"), "ts": b.get("ts"),
              "config_hash": b.get("config_hash"),
              "headline": b.get("headline")},
        "same_config": (a.get("config_hash") is not None
                        and a.get("config_hash") == b.get("config_hash")),
        "headline_ratio": None,
        "counters": {},
    }
    ha, hb = a.get("headline"), b.get("headline")
    if (isinstance(ha, dict) and isinstance(hb, dict)
            and ha.get("metric") == hb.get("metric")
            and isinstance(ha.get("value"), (int, float))
            and isinstance(hb.get("value"), (int, float))
            and ha["value"]):
        diff["headline_ratio"] = hb["value"] / ha["value"]
    ca, cb = _counter_flat(a), _counter_flat(b)
    for key in sorted(set(ca) | set(cb)):
        va, vb = ca.get(key), cb.get(key)
        if va != vb:
            diff["counters"][key] = {"a": va, "b": vb}
    return diff


def regression_check(records: List[dict], metric: str,
                     tolerance: float = 0.15, window: int = 3) -> dict:
    """Min-of-N noise-band regression gate: compare the NEWEST record
    carrying `metric` against the best of the up-to-`window` records
    before it. Host noise only ever makes a run look slower, so the
    best previous value is the honest baseline; `tolerance` is the
    band a single noisy rep may dip below it without failing. Metrics
    whose unit is seconds are lower-is-better; everything else
    (throughput) is higher-is-better."""
    matching = [
        r for r in records
        if isinstance(r.get("headline"), dict)
        and r["headline"].get("metric") == metric
        and isinstance(r["headline"].get("value"), (int, float))
    ]
    if len(matching) < 2:
        return {
            "metric": metric, "status": "insufficient",
            "records": len(matching), "regressed": False,
        }
    cur = matching[-1]["headline"]["value"]
    prev = [r["headline"]["value"] for r in matching[-(window + 1):-1]]
    unit = matching[-1]["headline"].get("unit", "")
    lower_better = "second" in unit
    if lower_better:
        base = min(prev)
        regressed = cur > base * (1.0 + tolerance)
    else:
        base = max(prev)
        regressed = cur < base * (1.0 - tolerance)
    return {
        "metric": metric,
        "status": "regressed" if regressed else "ok",
        "current": cur,
        "baseline": base,
        "window": len(prev),
        "tolerance": tolerance,
        "lower_is_better": lower_better,
        "ratio": (cur / base) if base else None,
        "regressed": regressed,
    }


def backfill(paths, ledger_file: Optional[str] = None) -> int:
    """Append one `bench` record per metric row of each bench artifact
    (`bench_all_r*.json`: one JSON object a line, each with a `metric`
    key): headline = the row's metric, value and unit; extra = the
    artifact's name, its round (the first number in its stem) and the
    row's other keys; ts = the artifact's mtime; metrics null (a
    historical row carries no live registry state). Returns the number
    of records appended; raises ValueError on a line that does not
    parse or has no metric."""
    import pathlib
    import re

    appended = 0
    for path in paths:
        path = pathlib.Path(path)
        m = re.search(r"(\d+)", path.stem)
        m_round = int(m.group(1)) if m else -1
        mtime = path.stat().st_mtime
        for ln, line in enumerate(path.read_text().splitlines(), 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: unparseable line ({e})")
            if not isinstance(row, dict) or "metric" not in row:
                raise ValueError(f"{path}:{ln}: row without a metric key")
            extra = {"artifact": path.name, "round": m_round, "backfilled": True}
            extra.update({k: v for k, v in row.items() if k not in ("metric", "value", "unit")})
            append_record(
                "bench",
                headline={"metric": row["metric"], "value": row.get("value"),
                          "unit": row.get("unit", "")},
                extra=extra,
                ts=mtime,
                capture_metrics=False,
                path=ledger_file,
            )
            appended += 1
    return appended
