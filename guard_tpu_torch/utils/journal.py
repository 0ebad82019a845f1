"""Durability plane: the per-run sweep chunk journal + graceful drain.

The port's copy of guard_tpu/utils/journal.py. A sweep killed at chunk
400/500 (OOM-killer, spot preemption, CI timeout, operator SIGTERM)
would otherwise lose every completed chunk. This module externalizes
the in-flight run state so the process boundary becomes recoverable:

* **Run key** (`run_key`): sha256 over the journal schema version, the
  port's version and sources (`ops/plan.source_digest`), the device
  census (`cuda:<card name>` and the card count, `cpu`, or `host` for
  `--backend cpu`), the registry content digest (rule bytes in order),
  the ordered doc-path + content manifest, and the output-config hash.
  Any change to the rules, ANY document's bytes, an output-affecting
  flag, the port's code or the device changes the key, so a stale
  journal can never replay: it keys to a file that does not exist and
  the run is a logged cold start. (The JAX package's key holds its
  version string but neither its sources nor the device.)

* **Chunk journal** (`SweepJournal` / `load_journal`): an append-only
  JSONL file `<run_key>.journal.jsonl` under `GUARD_TPU_JOURNAL_DIR`
  (default `~/.cache/guard_tpu_torch/journal`). One header line, then
  one record per completed chunk carrying the chunk's manifest record
  (tally fold, failed list, quarantine records), the stderr text the
  chunk emitted, and the fault/recovery counter deltas: everything
  `sweep --resume` needs to replay the chunk without touching encode or
  the device. Each append is one write + flush at the chunk's
  checkpoint; a torn tail record (no trailing newline, or undecodable
  JSON) is truncated at load, never trusted. A REAL write failure
  (ENOSPC, unwritable store) downgrades journaling to off with one
  warning, never a failed run, while an injected `journal` fault
  (`utils/faults.py`) propagates, simulating the mid-run crash a resume
  needs.

* **Drain latch** (`DrainLatch` / `install_signal_drain`): SIGTERM or
  SIGINT trips the latch; the sweep loop finishes its in-flight chunk,
  syncs the journal, dumps the flight recorder and exits with the
  distinct `DRAIN_EXIT_CODE` (75, EX_TEMPFAIL: "try again"; the journal
  makes that literal).

Unlike the JAX package the port has no environment twins of
`--no-journal` and `--resume` (GUARD_TPU_SWEEP_JOURNAL,
GUARD_TPU_SWEEP_RESUME). Observability: the `resume` counter group
(registered in utils/telemetry.py, present in every snapshot) counts
journaled and replayed chunks, stale cold starts, torn records,
degradations and drained sessions.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import signal
import threading
from pathlib import Path
from typing import Dict, List, Optional

from .faults import maybe_fail
from .telemetry import RESUME_COUNTERS
from .telemetry import span as _span

log = logging.getLogger("guard_tpu_torch.journal")

#: bump when the journal record layout changes — old journals then key
#: to different run keys and age out as cold starts
JOURNAL_SCHEMA_VERSION = 1

#: the graceful-drain exit code: distinct from the validate/sweep
#: ladder (0 pass / 19 fail / 5 error) and the BrokenPipe 141 —
#: EX_TEMPFAIL, because a drained run is exactly "try again": the
#: journal holds every completed chunk and `--resume` finishes the rest
DRAIN_EXIT_CODE = 75


def journal_dir() -> Path:
    d = os.environ.get("GUARD_TPU_JOURNAL_DIR", "").strip()
    if d:
        return Path(d)
    return Path(os.path.expanduser("~")) / ".cache" / "guard_tpu_torch" / "journal"


def drain_timeout_s() -> float:
    """Bound on a drain's wait for in-flight work
    (GUARD_TPU_DRAIN_TIMEOUT_MS, default 5000): the serve session's
    listener and coalescing batcher (commands/serve.py)."""
    raw = os.environ.get("GUARD_TPU_DRAIN_TIMEOUT_MS", "").strip()
    try:
        return max(0.0, float(raw) if raw else 5000.0) / 1000.0
    except ValueError:
        return 5.0


# -- run-key derivation ------------------------------------------------


def rules_digest(rule_files) -> str:
    """Registry content digest: sha256 chain over the rule bytes in
    order, the content component of `ops/plan.plan_key`, computable
    without touching the device (a `--backend cpu` sweep journals too)."""
    h = hashlib.sha256()
    for rf in rule_files:
        content = rf.content
        if isinstance(content, str):
            content = content.encode()
        h.update(hashlib.sha256(content).digest())
    return h.hexdigest()


def doc_manifest_digest(paths) -> str:
    """Ordered doc-path + content manifest: one sha256 over every
    document's (path, content sha256) pair in corpus order. Content,
    not mtime — a doc rewritten with identical bytes keeps the key, a
    one-byte change anywhere is a different run. An unreadable file
    contributes its error class, so a doc BECOMING readable also
    changes the key."""
    h = hashlib.sha256()
    for p in paths:
        try:
            digest = hashlib.sha256(Path(p).read_bytes()).hexdigest()
        except OSError as e:
            digest = f"unreadable:{type(e).__name__}"
        h.update(f"{p}\0{digest}\n".encode())
    return h.hexdigest()


def run_key(rules_part: str, docs_part: str, cfg_hash: str,
            device_census: str, source: Optional[str] = None) -> str:
    """Content address of one sweep run, the `result_key` derivation
    discipline applied at run scope: labeled fields, sha256.
    `device_census` names the device the run evaluates on (the plan
    key's `<kind>x<count>`, or `host` off the device) and `source` the
    port's source digest (default `ops/plan.source_digest()`), so a
    journal written by other code or on another device never replays."""
    from .. import __version__

    if source is None:
        from ..ops.plan import source_digest

        source = source_digest()
    h = hashlib.sha256()
    h.update(b"guard_tpu_torch;")
    h.update(f"schema={JOURNAL_SCHEMA_VERSION};".encode())
    h.update(f"version={__version__};".encode())
    h.update(f"source={source};".encode())
    h.update(f"device={device_census};".encode())
    h.update(f"plan={rules_part};".encode())
    h.update(f"docs={docs_part};".encode())
    h.update(f"config={cfg_hash};".encode())
    return h.hexdigest()


def journal_path(key: str) -> Path:
    return journal_dir() / f"{key}.journal.jsonl"


# -- load / replay -----------------------------------------------------


def load_journal(key: str, n_chunks: Optional[int] = None) -> Dict[int, dict]:
    """The replay map for one run key: {chunk index: chunk record},
    last record per chunk wins (a twice-interrupted run appends).
    Returns {} for an absent journal — with a content-addressed key
    that IS the stale case, logged by the caller as a cold start.

    Trust discipline: a header whose schema/run_key (or chunk count,
    when the caller passes one) does not match discards the whole
    file; a torn tail record — no trailing newline, or a line that
    fails to decode — is truncated, never trusted, and everything
    after a torn line is unreachable by construction (appends are
    ordered), so it is dropped too."""
    path = journal_path(key)
    try:
        if not path.exists():
            return {}
        raw = path.read_bytes()
    except OSError as e:
        log.warning("journal %s unreadable (%s); cold start", path.name, e)
        return {}
    lines = raw.split(b"\n")
    if raw and not raw.endswith(b"\n"):
        # torn tail: the interrupted append never completed its line
        lines = lines[:-1]
        RESUME_COUNTERS["torn_records_dropped"] += 1
    header_ok = False
    replay: Dict[int, dict] = {}
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            # a torn record mid-file: nothing after it was written by
            # a completed append — truncate here
            RESUME_COUNTERS["torn_records_dropped"] += 1
            break
        if not isinstance(rec, dict):
            RESUME_COUNTERS["torn_records_dropped"] += 1
            break
        kind = rec.get("kind")
        if kind == "header":
            if (
                rec.get("schema") != JOURNAL_SCHEMA_VERSION
                or rec.get("run_key") != key
                or (n_chunks is not None
                    and rec.get("chunks") != n_chunks)
            ):
                log.warning(
                    "journal %s header mismatch; cold start", path.name
                )
                return {}
            header_ok = True
            continue
        if kind == "chunk" and header_ok and isinstance(
            rec.get("rec"), dict
        ):
            replay[int(rec["chunk"])] = rec
    return replay


# -- append ------------------------------------------------------------


class SweepJournal:
    """Append-only writer for one run's chunk journal. Degradation
    contract: a real write failure (ENOSPC, read-only store) logs ONE
    warning, bumps `resume.journal_degraded`, and turns every later
    append into a no-op; the sweep itself never fails because the
    journal could not persist. The `journal` fault point fires BEFORE
    the write and propagates: a simulated mid-run crash, at exactly the
    boundary a SIGKILL would tear."""

    def __init__(self, key: str, n_chunks: int):
        self.key = key
        self.n_chunks = n_chunks
        self._f = None
        self._dead = False

    def _ensure_open(self) -> bool:
        if self._dead:
            return False
        if self._f is not None:
            return True
        try:
            path = journal_path(self.key)
            path.parent.mkdir(parents=True, exist_ok=True)
            fresh = not path.exists()
            self._f = open(path, "a", encoding="utf-8")
            if fresh:
                self._write_line({
                    "kind": "header",
                    "schema": JOURNAL_SCHEMA_VERSION,
                    "run_key": self.key,
                    "chunks": self.n_chunks,
                })
        except Exception as e:  # noqa: BLE001 — degrade, never fail
            self._degrade(e)
            return False
        return True

    def _write_line(self, rec: dict) -> None:
        # flush (page cache) per append, fsync only at sync()/close():
        # a record survives process death once flushed, and resume
        # correctness never depends on durability anyway: a tail lost
        # to power failure is just a chunk that re-evaluates
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def _degrade(self, exc: BaseException) -> None:
        log.warning(
            "journal write failed (%s); continuing without "
            "checkpointing — this run cannot be resumed", exc,
        )
        RESUME_COUNTERS["journal_degraded"] += 1
        self._dead = True
        self.close()

    def append_chunk(self, ci: int, rec: dict, stderr_text: str,
                     fault_delta: Optional[dict] = None) -> None:
        """Checkpoint one completed chunk at its `_finish_chunk`
        boundary: the manifest record verbatim, the chunk's stderr
        text, and the fault/recovery counter movement."""
        # the injected crash point, OUTSIDE the degradation try: it
        # kills the run here, between chunk completion and its
        # checkpoint (the torn-boundary case)
        maybe_fail("journal", key=f"chunk{ci}")
        if not self._ensure_open():
            return
        with _span("journal_append", {"chunk": ci}):
            try:
                line = {
                    "kind": "chunk",
                    "chunk": ci,
                    "rec": rec,
                    "stderr": stderr_text,
                }
                if fault_delta:
                    line["faults"] = fault_delta
                self._write_line(line)
            except Exception as e:  # noqa: BLE001 — degrade, never fail
                self._degrade(e)
                return
        RESUME_COUNTERS["chunks_journaled"] += 1

    def sync(self) -> None:
        """Drain-path barrier: make sure everything appended so far is
        on disk before the process exits."""
        if self._f is None or self._dead:
            return
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError:
            pass

    def close(self) -> None:
        f, self._f = self._f, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
            except OSError:
                pass
            try:
                f.close()
            except OSError:
                pass


# -- graceful drain ----------------------------------------------------


class DrainLatch:
    """The shutdown latch a sweep polls between chunks.
    Injectable: tests construct and trip one directly (no wall-clock),
    production installs it on SIGTERM/SIGINT via
    `install_signal_drain`."""

    def __init__(self):
        self._ev = threading.Event()
        self.reason: Optional[str] = None

    def trip(self, reason: str = "signal") -> None:
        if self.reason is None:
            self.reason = reason
        self._ev.set()

    def tripped(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)


def install_signal_drain(latch: DrainLatch):
    """Point SIGTERM/SIGINT at the latch; returns a restore() callable
    for the session's finally. Installable only from the main thread
    (signal module rule) — anywhere else this is a silent no-op and
    the latch stays test-injectable."""
    previous: List[tuple] = []

    def _handler(signum, _frame):
        latch.trip(signal.Signals(signum).name)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous.append((sig, signal.signal(sig, _handler)))
    except ValueError:
        # not the main thread: leave handlers alone
        for sig, old in previous:
            signal.signal(sig, old)
        previous = []

    def _restore() -> None:
        for sig, old in previous:
            try:
                signal.signal(sig, old)
            except ValueError:
                pass

    return _restore


# -- session epilogue handoff -----------------------------------------

#: the most recent resume's (run key, replayed count), read-then-
#: cleared by cli._session_epilogue for the ledger record (the same
#: gauge-then-zero handoff the delta fraction uses)
_LAST_RESUME: List[Optional[dict]] = [None]


def note_resume(key: str, replayed: int) -> None:
    RESUME_COUNTERS["runs_resumed"] += 1
    RESUME_COUNTERS["chunks_replayed"] += replayed
    _LAST_RESUME[0] = {"resumed_from": key, "chunks_replayed": replayed}


def pop_resume_info() -> Optional[dict]:
    info, _LAST_RESUME[0] = _LAST_RESUME[0], None
    return info
