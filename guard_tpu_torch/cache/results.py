"""Content-addressed per-document result cache.

The port's copy of guard_tpu/cache/results.py. The plan layer
(`ops/plan.py`) makes the programs warm; this layer makes the results
warm. A CI fleet re-validating a corpus that is 99% unchanged between
commits pays encode and device dispatch only for the delta: each
document's validation outcome is persisted keyed by

    sha256(result schema version;
           plan digest            -- covers rule bytes in order, the
                                     port's version and sources
                                     (plan.source_digest), the device
                                     census
                                     (`cuda:<card name>` and the card
                                     count, or `cpu`), bucket shape,
                                     pack config
           doc content sha256;
           output-mode/config hash)

so invalidation is purely structural — any change to the document
bytes, the rule content, the port's code or the device changes the
key, and a run on the card never replays a CPU run's entry. No mtime
heuristics, no TTLs.

Entries store materialized report fragments and rule statuses — NOT
raw stdout bytes — and are replayed through the lazy report path, so
every output format reconstructs exactly. Each entry is the JAX
package's entry document (schema, version, key, payload as JSON), but
where the JAX package writes one file per document, the port keeps
every entry as a row of one SQLite database in the cache directory
(`results.sqlite3`) and reads and writes a run's entries in one batch
each (`load_entries`, `store_entries`): one transaction per run instead
of a file per document. A corrupt, truncated or mismatched entry is a
logged MISS (rewritten after the recompute), never an error; a database
file that is not one is a miss for every document and is replaced by
the next store. The `cache` and `store_write` fault points
(`utils/faults.py`) fire per entry and prove the degradation paths.

The cache is on by default, under `GUARD_TPU_RESULT_CACHE_DIR` (default
`~/.cache/guard_tpu_torch/results`); `--no-result-cache` bypasses it
entirely (full dispatch, the same bytes). Unlike the JAX package the
port has no `GUARD_TPU_RESULT_CACHE` environment switch.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import sqlite3
from contextlib import closing
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from ..utils.faults import maybe_fail
from ..utils.telemetry import REGISTRY as _TELEMETRY
from ..utils.telemetry import span as _span

log = logging.getLogger("guard_tpu_torch.result_cache")

#: bump when the entry layout changes — old entries then key to
#: different digests and age out as misses
RESULT_SCHEMA_VERSION = 1

#: the telemetry group "result_cache", in every --metrics-out snapshot:
#: `hits`/`misses` per-doc lookup outcomes (a warm run shows hits ==
#: docs and no kernel launch), `stores` write-backs, `corrupt_entries`
#: the subset of misses that found an unusable entry on disk, bytes_*
#: disk traffic.
RESULT_COUNTERS = _TELEMETRY.counter_group(
    "result_cache",
    {
        "hits": 0,
        "misses": 0,
        "stores": 0,
        "corrupt_entries": 0,
        "bytes_loaded": 0,
        "bytes_stored": 0,
    },
)


def result_cache_stats() -> dict:
    return _TELEMETRY.group_stats("result_cache")


def reset_result_cache_stats() -> None:
    _TELEMETRY.reset_group("result_cache")


def set_delta_gauge(delta_docs: int, total_docs: int) -> None:
    """Publish the partition outcome of one run: how many docs had to
    encode+dispatch, out of how many eligible."""
    _TELEMETRY.set_gauge("result_cache.delta_docs", int(delta_docs))
    _TELEMETRY.set_gauge("result_cache.total_docs", int(total_docs))


def result_cache_dir() -> Path:
    d = os.environ.get("GUARD_TPU_RESULT_CACHE_DIR", "").strip()
    if d:
        return Path(d)
    return Path(os.path.expanduser("~")) / ".cache" / "guard_tpu_torch" / "results"


def doc_digest(content) -> str:
    """sha256 of one document's bytes (str content hashes its utf-8)."""
    if isinstance(content, str):
        content = content.encode()
    return hashlib.sha256(content).hexdigest()


def config_hash(**fields) -> str:
    """Hash of everything in the OUTPUT contract that is not covered by
    the plan digest or the doc bytes: output mode, summary type, rule
    naming, packing mode — any knob that changes report text or tally
    shape for the same validation verdict. Key/value JSON so field
    order cannot perturb the digest."""
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def result_key(plan_digest: str, doc_sha: str, cfg_hash: str) -> str:
    """Content address of one (doc, registry, output config) result."""
    h = hashlib.sha256()
    h.update(f"schema={RESULT_SCHEMA_VERSION};".encode())
    h.update(f"plan={plan_digest};".encode())
    h.update(f"doc={doc_sha};".encode())
    h.update(f"config={cfg_hash};".encode())
    return h.hexdigest()


#: the database of every entry, in the cache directory
DB_NAME = "results.sqlite3"

# keys per SELECT (under SQLite's default bound-parameter limit)
_LOOKUP_CHUNK = 500


def db_path() -> Path:
    return result_cache_dir() / DB_NAME


def _connect(path: Path) -> sqlite3.Connection:
    conn = sqlite3.connect(str(path), timeout=60)
    conn.execute("CREATE TABLE IF NOT EXISTS entries (key TEXT PRIMARY KEY, blob BLOB NOT NULL)")
    return conn


def _write_rows(path: Path, rows) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with closing(_connect(path)) as conn, conn:
        conn.executemany("INSERT OR REPLACE INTO entries (key, blob) VALUES (?, ?)", rows)


def store_entries(items: Sequence[Tuple[str, dict]]) -> int:
    """Persist a run's (key, payload) entries in one transaction, so
    concurrent writers and torn writes leave every entry whole or
    absent. An entry whose serialization or injected fault fails is
    left out with a warning; a database that cannot be written warns
    and stores nothing, and one that is not a database is replaced.
    Persistence is an optimization, never a correctness dependency.
    Returns the number of entries stored."""
    with _span("cache_store", {"entries": len(items)}):
        rows = []
        for key, payload in items:
            try:
                maybe_fail("cache", key)
                # store_write: the persistence seams' shared fault point
                # (plan artifacts, result entries) — a full disk degrades
                # to cache-off, never a failed run
                maybe_fail("store_write", key)
                doc = {
                    "schema": RESULT_SCHEMA_VERSION,
                    "version": _guard_version(),
                    "key": key,
                    "payload": payload,
                }
                rows.append((key, json.dumps(doc, separators=(",", ":")).encode()))
            except Exception as e:
                log.warning("result-cache store failed (%s); continuing "
                            "without persistence", e)
        if not rows:
            return 0
        path = db_path()
        try:
            try:
                _write_rows(path, rows)
            except sqlite3.DatabaseError as e:
                if isinstance(e, sqlite3.OperationalError):
                    raise  # locked, read-only or full: not a damaged file
                log.warning("result-cache database %s unusable (%s); starting "
                            "a new one", path, e)
                path.unlink(missing_ok=True)
                _write_rows(path, rows)
        except Exception as e:
            log.warning("result-cache store failed (%s); continuing "
                        "without persistence", e)
            return 0
        RESULT_COUNTERS["stores"] += len(rows)
        RESULT_COUNTERS["bytes_stored"] += sum(len(blob) for _k, blob in rows)
        return len(rows)


def load_entries(requests: Sequence[Tuple[str, Optional[str]]]) -> List[Optional[dict]]:
    """Load a run's entries, one (key, name) request per document, in
    one read of the database: each payload, or None on ANY problem —
    absent entry, truncated JSON, schema/version/key mismatch, an
    unreadable database. A corrupt entry logs a warning and counts as a
    miss; the recompute's store rewrites it. Counters are the
    caller-facing hit/miss ledger: exactly one of hits/misses
    increments per request.

    `name` guards replay fidelity: report text embeds the document's
    file name, which the content-addressed key deliberately excludes.
    A same-content doc under a different name replays only when the
    writer marked the entry `portable` (the serialized name appears
    nowhere but the report's top-level name field, so the reader can
    substitute its own); otherwise the mismatch is a plain miss (not
    corrupt), recomputed and stored under the new name."""
    with _span("cache_lookup", {"entries": len(requests)}):
        blobs: dict = {}
        path = db_path()
        if requests and path.exists():
            keys = sorted({key for key, _name in requests})
            try:
                with closing(_connect(path)) as conn:
                    for lo in range(0, len(keys), _LOOKUP_CHUNK):
                        part = keys[lo:lo + _LOOKUP_CHUNK]
                        blobs.update(conn.execute(
                            "SELECT key, blob FROM entries WHERE key IN "
                            f"({','.join('?' * len(part))})", part,
                        ))
            except sqlite3.Error as e:
                log.warning("result-cache database %s unreadable (%s); treating "
                            "every document as a cache miss", path, e)
                blobs = {}
        return [_decode(key, blobs.get(key), name) for key, name in requests]


def _decode(key: str, blob, name: Optional[str]) -> Optional[dict]:
    """One request's payload from its stored blob (None: absent)."""
    try:
        maybe_fail("cache", key)
        if blob is None:
            RESULT_COUNTERS["misses"] += 1
            return None
        doc = json.loads(blob)
        if not isinstance(doc, dict):
            raise ValueError("entry is not an object")
        if doc.get("schema") != RESULT_SCHEMA_VERSION:
            raise ValueError(
                f"schema {doc.get('schema')!r} != "
                f"{RESULT_SCHEMA_VERSION}"
            )
        if doc.get("version") != _guard_version():
            raise ValueError("guard_tpu_torch version mismatch")
        if doc.get("key") != key:
            raise ValueError("key mismatch")
        payload = doc.get("payload")
        if not isinstance(payload, dict):
            raise ValueError("entry payload is not an object")
    except Exception as e:
        log.warning(
            "result-cache entry %s unusable (%s); treating as a "
            "cache miss", key, e,
        )
        RESULT_COUNTERS["misses"] += 1
        RESULT_COUNTERS["corrupt_entries"] += 1
        return None
    if (
        name is not None
        and payload.get("name") != name
        and not payload.get("portable")
    ):
        RESULT_COUNTERS["misses"] += 1
        return None
    RESULT_COUNTERS["hits"] += 1
    RESULT_COUNTERS["bytes_loaded"] += len(blob)
    return payload


def _guard_version() -> str:
    from .. import __version__

    return __version__
