"""The `sweep` command: resumable batch evaluation over large corpora.

The port of guard_tpu/commands/sweep.py. The corpus is split into
deterministic chunks, each chunk evaluates on the device (statuses
only; use `validate` for rich reports), and a JSONL manifest records
one line per completed chunk. Re-running with the same manifest skips
completed chunks whose content signature still matches, so an
interrupted sweep resumes where it stopped.

Exit codes follow `validate` (0 pass / 19 fail / 5 error), plus 75 for
a graceful drain (utils/journal.DRAIN_EXIT_CODE).

The planes, in the JAX package's names and order:

* **the chunk loop on the host** (`_execute`, `_read_chunk`,
  `_evaluate_chunk`, `_tally_chunk`, the manifest): `--backend cpu`
  evaluates every chunk on the CPU evaluator (`_eval_oracle`);
* **the card** (`--backend tpu`, the default): each chunk is encoded
  into bucket groups (`ops/encoder.encode_chunk_texts`), relocated into
  the registry's plan (`ops/plan.get_plan`, `relocate_batch`), and the
  files that share its program are dispatched as packs
  (`ops/backend.dispatch_packs`: one walk and one K3 rim reduction per
  (pack, bucket)); the other files walk bucket by bucket on their own
  (`parallel/device.evaluate_groups`). The tallies fold the K3 blocks'
  last-rule-wins column (`_outcomes_vectorized`), or the statuses under
  `--no-vector-rim` (`_outcomes_scalar`). Documents the card does not
  hold (beyond the last bucket, exotic numbers, a function that
  raised), host rules and unsure bits rerun on the CPU evaluator. Only
  a GuardError (an injected `dispatch`/`collect` fault, a
  GUARD_TPU_DISPATCH_TIMEOUT timeout) takes the ladder of
  `collect_packs`; a kernel or CUDA error ends the run with code 5.
  The JAX package catches every exception of its packed plane and
  falls back to per-file dispatch, which would hide a kernel that does
  not build or launch. `--mesh-shape` is resolved with the JAX
  grammar: a malformed shape falls back to per-file dispatch with the
  JAX package's warning, and every shape runs unsharded on one card;
  `--rule-shards N` runs unsharded too (the JAX package clamps its rule
  groups to the device count, so one device runs one group);
* **the result cache** (`_cache_lookup`, `_cache_subset`, the store in
  `_tally_chunk`): unchanged documents replay their outcome; a chunk's
  keys are read in one batch and its entries written in one transaction
  of the port's SQLite store, where the JAX package opens a file per
  document. A chunk during which any fault counter moved stores nothing;
* **the pipeline** (`_run_pipeline`, ingest workers >= 1): worker
  processes read and encode chunks ahead (parallel/ingest._chunk_job),
  the main thread dispatches chunk k and folds chunk k-1 while the card
  runs k; the dispatch is asynchronous on the evaluator's CUDA stream.
  `--ingest-workers 0` is the serial double buffer (`_prepare`: chunk
  k+1 reads and encodes between chunk k's dispatch and collect);
* **the journal** (utils/journal.py): every completed chunk is
  checkpointed; `--resume` replays the journaled chunks (no read, no
  encode, no launch) and continues. A resumed run's `evaluated` counts
  the replayed chunks on every path, so its stdout is the uninterrupted
  run's; the JAX package's pipelined path (ingest workers >= 1)
  assigns its own chunk count there and drops them
  (guard_tpu/commands/sweep.py:365);
* **streaming CI mode** (`--follow`): documents arrive as JSONL on
  stdin, one line per document, either a bare JSON document or an
  `{"name": ..., "content": ...}` envelope, and validate as they arrive
  in micro-batches against the plan warmed once before the stream
  opens. GUARD_TPU_FOLLOW_WAIT_MS bounds how long a document waits for
  peers (default 10 ms; 0 dispatches every arrival alone) and
  GUARD_TPU_FOLLOW_MAX_BATCH caps a batch (default 32). One JSONL
  result line answers every input line, in order (`{"name", "status",
  "fails"}`, or `{"name", "quarantined": {...}}` for a line that does
  not decode or a document that does not parse), then one summary line
  at EOF with the sweep's exit semantics. `admission.follow_docs` and
  `admission.follow_batches` count them.

The port has no environment twins of the flags (GUARD_TPU_PACK,
GUARD_TPU_VECTOR_RIM, GUARD_TPU_PLAN_CACHE, GUARD_TPU_ANALYSIS,
GUARD_TPU_RESULT_CACHE, GUARD_TPU_MESH, GUARD_TPU_SWEEP_JOURNAL,
GUARD_TPU_SWEEP_RESUME). It reads the settings no flag stands for under
the JAX package's names: GUARD_TPU_JOURNAL_DIR, GUARD_TPU_INGEST_DEPTH,
GUARD_TPU_INGEST_CHUNK_TIMEOUT, GUARD_TPU_RETRY_BACKOFF,
GUARD_TPU_FOLLOW_WAIT_MS and GUARD_TPU_FOLLOW_MAX_BATCH.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from ..core.errors import GuardError, ParseError
from ..core.evaluator import eval_rules_file
from ..core.loader import load_document
from ..core.parser import parse_rules_file
from ..core.qresult import Status
from ..core.scopes import RootScope
from ..utils.faults import FAULT_COUNTERS, maybe_fail, quarantine_record
from ..utils.io import Reader, Writer
from ..utils.telemetry import ADMISSION_COUNTERS, PIPELINE_COUNTERS
from ..utils.telemetry import ingest_worker_spans as _ingest_worker_spans
from ..utils.telemetry import span as _span
from .files import DATA_FILE_EXTENSIONS, RULE_FILE_EXTENSIONS, gather
from .validate import (
    ERROR_STATUS_CODE,
    FAILURE_STATUS_CODE,
    SUCCESS_STATUS_CODE,
    DataFile,
    RuleFile,
)

log = logging.getLogger("guard_tpu_torch.sweep")

_STATUS_NAMES = ("pass", "fail", "skip")

#: pool-crash recovery gives up restarting after this many crashes in
#: one run and stays inline (a persistently dying pool would otherwise
#: pay spawn cost on every remaining chunk)
_MAX_POOL_RESTARTS = 3


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _chunk_timeout() -> float:
    """Bound on one worker chunk job (GUARD_TPU_INGEST_CHUNK_TIMEOUT,
    seconds): a worker killed mid-job loses the job, and the bound turns
    a hung pool into the same recovery path as a crashed one."""
    return _env_float("GUARD_TPU_INGEST_CHUNK_TIMEOUT", 300.0)


def _retry_backoff() -> float:
    """Base of the pool-restart exponential backoff in seconds
    (GUARD_TPU_RETRY_BACKOFF; tests set 0 for speed)."""
    return _env_float("GUARD_TPU_RETRY_BACKOFF", 0.05)


def _follow_wait_s() -> float:
    """Micro-batch formation window for --follow, in seconds
    (GUARD_TPU_FOLLOW_WAIT_MS, default 10 ms): a document never waits
    longer than this for peers; 0 dispatches every arrival alone."""
    return max(0.0, _env_float("GUARD_TPU_FOLLOW_WAIT_MS", 10.0)) / 1000.0


def _follow_max_batch() -> int:
    """Micro-batch size cap for --follow (GUARD_TPU_FOLLOW_MAX_BATCH,
    default 32)."""
    raw = os.environ.get("GUARD_TPU_FOLLOW_MAX_BATCH", "").strip()
    try:
        n = int(raw) if raw else 32
    except ValueError:
        n = 32
    return max(1, n)


def _chunk_signature(paths: List[Path]) -> str:
    h = hashlib.sha256()
    for p in paths:
        st = p.stat()
        h.update(f"{p}\0{st.st_size}\0{int(st.st_mtime)}\n".encode())
    return h.hexdigest()[:16]


def _read_manifest(path: Path) -> Dict[int, dict]:
    """Last record per chunk index wins (a re-run appends)."""
    done: Dict[int, dict] = {}
    if not path.exists():
        return done
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail write from an interrupted run
        if isinstance(rec, dict) and "chunk" in rec:
            done[int(rec["chunk"])] = rec
    return done


class _ErrCapture:
    """File-like err sink buffering one chunk's stderr for the journal.
    Flushed to the real stream at the chunk's checkpoint, so a live
    journal-on run and a resumed replay emit the same bytes in the same
    order."""

    def __init__(self, buf: list):
        self._buf = buf

    def write(self, s: str) -> None:
        self._buf.append(s)

    def flush(self) -> None:
        pass


def _fault_level() -> int:
    """Sum of every failure-plane counter, compared around one chunk's
    compute: any movement (injected faults, retries, fallbacks,
    quarantines) disqualifies that chunk's result-cache stores."""
    return int(sum(FAULT_COUNTERS.values()))


def _summary_rc(errors: int, quarantined: list, totals: dict,
                max_doc_failures: Optional[int]) -> int:
    """Exit code of a sweep: quarantined documents are a partial
    failure, ERROR only past --max-doc-failures (default unlimited; 0:
    any quarantined document fails the run). Errors that are not
    quarantines (rule parse errors, oracle evaluation errors) stay
    fatal."""
    doc_failures = len(quarantined)
    if max(0, errors - doc_failures):
        return ERROR_STATUS_CODE
    limit = max_doc_failures
    if limit is not None and limit >= 0 and doc_failures > limit:
        return ERROR_STATUS_CODE
    if totals["fail"]:
        return FAILURE_STATUS_CODE
    return SUCCESS_STATUS_CODE


@dataclass
class Sweep:
    rules: List[str] = field(default_factory=list)
    data: List[str] = field(default_factory=list)
    manifest: str = "sweep-manifest.jsonl"
    chunk_size: int = 1024
    backend: str = "tpu"  # tpu (the card) | cpu (the CPU evaluator)
    # accepted with the JAX package's meaning; one card runs one group
    rule_shards: int = 1
    last_modified: bool = False
    # fuse the files that share the shared encode's program into packs:
    # one walk and one K3 per (pack, bucket); --no-pack walks each file
    pack_rules: bool = True
    # the K3 rim blocks fold the tallies; --no-vector-rim launches no
    # K3 and folds the per-document status dicts instead
    vector_rim: bool = True
    # ingest worker processes (parallel/ingest.py). None = auto
    # (GUARD_TPU_INGEST_WORKERS, else cpu_count - 1 capped at 4); 0 =
    # the serial double buffer; 1 = the pipeline with inline encode
    ingest_workers: Optional[int] = None
    # a document whose read/parse/encode fails is quarantined (a record
    # in the manifest and the summary, the rest of its chunk proceeds);
    # the run exits ERROR only past this many. None = unlimited
    max_doc_failures: Optional[int] = None
    # the plan layer (ops/plan.py): lower and pack the registry once,
    # relocate each chunk; --no-plan-cache lowers per chunk
    plan_cache: bool = True
    # the plan/IR verifier (analysis/verify.py) around plan build, load
    # and relocation; --no-verify-plans skips it
    verify_plans: bool = True
    # the result cache (cache/results.py): unchanged documents replay
    # their outcome; --no-result-cache dispatches every document
    result_cache: bool = True
    # --delta-stats: one stderr line with the cache's partition
    delta_stats: bool = False
    # --follow: documents arrive as JSONL on stdin (module docstring)
    follow: bool = False
    # the chunk journal (utils/journal.py); --no-journal turns it off
    journal: bool = True
    # --resume: replay the journaled chunks, then continue
    resume: bool = False
    # the graceful-drain latch: SIGTERM/SIGINT trip it (handlers
    # installed by execute on the main thread); tests inject one. A
    # tripped latch lets the in-flight chunk finish, syncs the journal
    # and exits DRAIN_EXIT_CODE.
    drain_latch: Optional[object] = None
    # --mesh-shape (the JAX grammar; every shape runs unsharded)
    mesh_shape: Optional[str] = None
    # the torch device of the tpu backend: CUDA unless named
    device: Optional[str] = None

    def execute(self, writer: Writer, reader: Reader) -> int:
        """Latch + journal lifecycle around the sweep body: resolve the
        device (no card and no --device raises), install the
        SIGTERM/SIGINT drain handlers (restored on exit), make sure the
        journal is synced and closed however the body exits, and map a
        tripped latch to the drain exit code."""
        from ..utils import journal as jn
        from ..utils.telemetry import RESUME_COUNTERS

        self._dev = None
        if self.backend == "tpu":
            from ..parallel.device import resolve_device

            self._dev = resolve_device(self.device)
        self._drain = self.drain_latch if self.drain_latch is not None \
            else jn.DrainLatch()
        self._journal = None
        self._replay: Dict[int, dict] = {}
        self._err_bufs: Dict[int, list] = {}
        restore = jn.install_signal_drain(self._drain)
        try:
            rc = self._execute(writer, reader)
        finally:
            restore()
            if self._journal is not None:
                self._journal.sync()
                self._journal.close()
        if self._drain.tripped():
            # drained, not failed: every completed chunk is journaled
            # and `--resume` finishes the rest
            RESUME_COUNTERS["drained_sessions"] += 1
            return jn.DRAIN_EXIT_CODE
        return rc

    def _execute(self, writer: Writer, reader: Reader) -> int:
        if not self.rules:
            raise GuardError("must specify rules")
        if self.follow:
            return self._run_follow(writer, reader)
        if not self.data:
            raise GuardError("must specify data")
        if self.chunk_size < 1:
            raise GuardError("chunk-size must be >= 1")

        rule_files, parse_errors = self._parse_rules(writer)
        if not rule_files:
            writer.writeln_err("no parseable rule files")
            return ERROR_STATUS_CODE

        paths = list(gather(self.data, DATA_FILE_EXTENSIONS, self.last_modified))
        chunks = [
            paths[i : i + self.chunk_size]
            for i in range(0, len(paths), self.chunk_size)
        ]

        manifest_path = Path(self.manifest)
        done = _read_manifest(manifest_path)
        manifest_path.parent.mkdir(parents=True, exist_ok=True)

        evaluated = skipped = 0
        # the cache's [hits, delta docs] over every chunk this run
        # partitioned (--delta-stats and the ledger's delta fraction)
        self._delta_seen = [0, 0]
        self._journal_setup(rule_files, paths, chunks)
        todo = []
        replay_rows: List[dict] = []
        for ci, chunk in enumerate(chunks):
            jrec = self._replay.get(ci)
            if jrec is not None:
                # the journaled record IS the chunk's outcome: no read,
                # no encode, no launch. Replay outranks the signature
                # skip below (the run key already pinned content) and
                # counts as `evaluated`, so summary and exit bytes match
                # the uninterrupted run.
                rec = jrec["rec"]
                if done.get(ci) != rec:
                    # a crash between journal append and manifest write
                    # (the append is first) left this row missing:
                    # repair in chunk order below, so the manifest ends
                    # byte-identical to an uninterrupted run's
                    replay_rows.append(rec)
                done[ci] = rec
                evaluated += 1
                stderr_text = jrec.get("stderr") or ""
                if stderr_text:
                    writer.write_err(stderr_text)
                for k, v in (jrec.get("faults") or {}).items():
                    if k in FAULT_COUNTERS:
                        FAULT_COUNTERS[k] += int(v)
                continue
            sig = _chunk_signature(chunk)
            prev = done.get(ci)
            if prev is not None and prev.get("sig") == sig:
                skipped += 1
                continue
            todo.append((ci, sig, chunk))
        if replay_rows:
            with manifest_path.open("a") as mf:
                for rec in replay_rows:
                    mf.write(json.dumps(rec) + "\n")

        # the three-stage pipeline on the card: ingest workers read and
        # encode chunks into a bounded prefetch queue, the main thread
        # dispatches chunk k and folds chunk k-1 while the card runs k.
        # --ingest-workers 0 is the serial double buffer below.
        workers = 0
        if self.backend == "tpu" and todo:
            from ..parallel.ingest import resolve_ingest_workers

            workers = resolve_ingest_workers(self.ingest_workers)
        if workers >= 1:
            evaluated += self._run_pipeline(
                todo, rule_files, done, manifest_path, writer, workers
            )
        else:
            # double-buffered encode/execute on the card: while the card
            # runs chunk k's dispatched packs, the host reads and
            # encodes chunk k+1 (the `prefetch` callback fires between
            # dispatch and collect)
            prepared: Dict[int, tuple] = {}

            def _prepare(j: int) -> None:
                if self.backend != "tpu" or j >= len(todo):
                    return
                ci2, _sig2, chunk2 = todo[j]
                if ci2 in prepared:
                    return
                err_box2 = [0, []]
                w2 = self._chunk_writer(writer, ci2)
                dfs = self._read_chunk(chunk2, w2, err_box2)
                # partition BEFORE encode: cached documents never encode
                ctx2 = self._cache_lookup(dfs, rule_files)
                delta2, _ = self._cache_subset(ctx2, dfs, None)
                enc = self._encode_chunk(delta2, w2, err_box2)
                prepared[ci2] = (dfs, ctx2, delta2, enc, err_box2)

            with manifest_path.open("a") as mf:
                for j, (ci, sig, chunk) in enumerate(todo):
                    if self._drain is not None and self._drain.tripped():
                        break  # graceful drain: stop between chunks
                    _prepare(j)
                    rec = self._evaluate_chunk(
                        ci, sig, chunk, rule_files,
                        self._chunk_writer(writer, ci),
                        prepared=prepared.pop(ci, None),
                        prefetch=(lambda j=j: _prepare(j + 1)),
                    )
                    self._checkpoint(ci, rec, writer, mf, done)
                    evaluated += 1

        with _span("report", {"chunks": len(chunks)}):
            totals = {k: 0 for k in _STATUS_NAMES}
            failed: List[dict] = []
            quarantined: List[dict] = []
            errors = parse_errors
            for ci in range(len(chunks)):
                rec = done.get(ci)
                if rec is None:
                    continue
                for k in _STATUS_NAMES:
                    totals[k] += rec["counts"].get(k, 0)
                failed.extend(rec.get("failed", []))
                quarantined.extend(rec.get("quarantined", []))
                errors += rec.get("errors", 0)
            summary = {
                "chunks": len(chunks),
                "evaluated": evaluated,
                "resumed": skipped,
                "documents": len(paths),
                "counts": totals,
                "failed": failed,
                "errors": errors,
                "manifest": str(manifest_path),
            }
            if quarantined:
                # keyed only when present, as in the JAX package
                summary["quarantined"] = quarantined
            writer.writeln(json.dumps(summary))
        self._emit_delta_stats(writer)
        return _summary_rc(errors, quarantined, totals, self.max_doc_failures)

    def _emit_delta_stats(self, writer: Writer) -> None:
        if self.delta_stats:
            hits, delta = self._delta_seen
            writer.writeln_err(
                f"result-cache: {hits}/{hits + delta} docs cached, "
                f"{delta} dispatched"
            )

    # -- the journal (utils/journal.py) ------------------------------
    def _journal_setup(self, rule_files, paths, chunks) -> None:
        """Derive the run key, arm the journal, and load the replay map
        when resuming. The key reads every document's bytes: a stale
        journal keys to a file that does not exist."""
        from ..cache.results import config_hash
        from ..utils import journal as jn
        from ..utils.telemetry import RESUME_COUNTERS

        if not self.journal:
            return
        with _span("journal_key", {"docs": len(paths)}):
            cfg = config_hash(
                mode="sweep",
                chunk_size=self.chunk_size,
                backend=self.backend,
                rule_shards=self.rule_shards,
                pack_rules=self.pack_rules,
                vector_rim=self.vector_rim,
                max_doc_failures=self.max_doc_failures,
                plan_cache=self.plan_cache,
                verify_plans=self.verify_plans,
                result_cache=self.result_cache,
                manifest=str(self.manifest),
            )
            census = "host"
            if self._dev is not None:
                from ..ops.plan import _device_fingerprint

                kind, count = _device_fingerprint(self._dev)
                census = f"{kind}x{count}"
            key = jn.run_key(
                jn.rules_digest(rule_files),
                jn.doc_manifest_digest(paths),
                cfg,
                census,
            )
        self._run_key = key
        self._fault_prev = {k: int(v) for k, v in FAULT_COUNTERS.items()}
        if self.resume:
            self._replay = jn.load_journal(key, n_chunks=len(chunks))
            if self._replay:
                jn.note_resume(key, len(self._replay))
            else:
                # an absent journal IS the stale case under a content-
                # addressed key: a logged cold start, never a wrong replay
                RESUME_COUNTERS["stale_cold_starts"] += 1
                jn.log.info("no journal for run %s; cold start", key[:16])
        self._journal = jn.SweepJournal(key, len(chunks))

    def _chunk_writer(self, writer: Writer, ci: int) -> Writer:
        """Journal on: a Writer whose err channel buffers into chunk
        ci's capture list, flushed in chunk order at the checkpoint
        (what the journal records and a replay re-emits). Journal off:
        the writer itself."""
        if self._journal is None:
            return writer
        buf = self._err_bufs.setdefault(ci, [])
        return Writer(out=writer.out, err=_ErrCapture(buf))

    def _checkpoint(self, ci, rec, writer, mf, done) -> None:
        """One chunk's completion boundary: flush its captured stderr,
        append the journal record (journal BEFORE manifest: a crash
        between the two leaves a journaled chunk whose missing manifest
        row a replay repairs), then the manifest row."""
        if self._journal is not None:
            stderr_text = "".join(self._err_bufs.pop(ci, ()))
            if stderr_text:
                writer.write_err(stderr_text)
            cur = {k: int(v) for k, v in FAULT_COUNTERS.items()}
            delta = {
                k: cur[k] - self._fault_prev.get(k, 0)
                for k in cur if cur[k] != self._fault_prev.get(k, 0)
            }
            self._fault_prev = cur
            self._journal.append_chunk(ci, rec, stderr_text, delta)
        done[ci] = rec
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    # -- streaming CI mode (--follow) --------------------------------
    def _run_follow(self, writer: Writer, reader: Reader) -> int:
        """Validate documents as they arrive on stdin: a feeder thread
        drains the JSONL stream into a bounded formation buffer, the
        main loop dispatches micro-batches (window-bounded and
        size-capped) against the plan warmed once up front, and one
        result line answers every input line in order. EOF emits the
        summary line and the sweep's exit code."""
        import threading
        import time
        from collections import deque

        rule_files, parse_errors = self._parse_rules(writer)
        if not rule_files:
            writer.writeln_err("no parseable rule files")
            return ERROR_STATUS_CODE
        # warm the plan BEFORE the stream opens: mid-stream latency is
        # relocation + dispatch, never a lowering stall
        if self.backend == "tpu" and self.plan_cache:
            from ..ops.plan import get_plan

            with _span("lower_compile", {"mode": "follow_warm"}):
                get_plan(rule_files, verify=self.verify_plans, device=self._dev)

        window = _follow_wait_s()
        max_batch = _follow_max_batch()
        buf: deque = deque()
        cv = threading.Condition()
        eof = [False]

        def _feed() -> None:
            # blank lines are ignored; only EOF ends the stream
            try:
                for raw in reader.stream():
                    raw = raw.strip()
                    if not raw:
                        continue
                    with cv:
                        buf.append(raw)
                        cv.notify_all()
            finally:
                with cv:
                    eof[0] = True
                    cv.notify_all()

        threading.Thread(
            target=_feed, daemon=True, name="guard-tpu-torch-follow"
        ).start()

        self._delta_seen = [0, 0]
        totals = {k: 0 for k in _STATUS_NAMES}
        failed: List[dict] = []
        quarantined: List[dict] = []
        errors = parse_errors
        n_docs = 0
        seq = [0]
        while True:
            if self._drain is not None and self._drain.tripped():
                break  # graceful drain: summary + DRAIN_EXIT_CODE
            with cv:
                while not buf and not eof[0]:
                    cv.wait()
                if not buf and eof[0]:
                    break
                if window > 0 and len(buf) < max_batch and not eof[0]:
                    # formation: wait up to the window for peers, never
                    # longer
                    deadline = time.monotonic() + window
                    while len(buf) < max_batch and not eof[0]:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        cv.wait(remaining)
                lines = [buf.popleft() for _ in range(min(len(buf), max_batch))]
            err_box = [0, []]
            entries = self._follow_docs(lines, seq, writer, err_box)
            data_files = [df for _, df, _rec in entries if df is not None]
            outcomes = self._follow_eval(data_files, rule_files, writer, err_box)
            ADMISSION_COUNTERS["follow_batches"] += 1
            ADMISSION_COUNTERS["follow_docs"] += len(lines)
            errors += err_box[0]
            if err_box[1]:
                quarantined.extend(err_box[1])
                FAULT_COUNTERS["quarantined_docs"] += len(err_box[1])
            by_name = {rec["file"]: rec for rec in err_box[1]}
            n_docs += len(lines)
            oi = 0
            for name, df, rec in entries:
                out = None
                if df is not None:
                    out = outcomes[oi]
                    oi += 1
                if out is None:
                    writer.writeln(json.dumps({
                        "name": name,
                        "quarantined": rec or by_name.get(name) or {"file": name},
                    }))
                    continue
                totals[out["status"]] += 1
                if out["fails"]:
                    failed.append({"data": name, "rules": out["fails"]})
                writer.writeln(json.dumps({
                    "name": name,
                    "status": out["status"],
                    "fails": out["fails"],
                }))
            writer.flush()

        summary = {
            "follow": True,
            "documents": n_docs,
            "counts": totals,
            "failed": failed,
            "errors": errors,
        }
        if quarantined:
            summary["quarantined"] = quarantined
        writer.writeln(json.dumps(summary))
        self._emit_delta_stats(writer)
        return _summary_rc(errors, quarantined, totals, self.max_doc_failures)

    def _follow_docs(self, lines, seq, writer, err_box):
        """Decode one micro-batch of stream lines into DataFiles.
        Returns [(name, DataFile | None, quarantine_rec | None)] in
        input order: a line that fails to decode quarantines at the
        `read` stage and still gets its result line."""
        entries = []
        for raw in lines:
            seq[0] += 1
            name = f"stream[{seq[0]}]"
            try:
                maybe_fail("read", key=name)
                env = json.loads(raw)
                if isinstance(env, dict) and "content" in env:
                    name = str(env.get("name") or name)
                    content = env["content"]
                    if not isinstance(content, str):
                        # an inline document object: its canonical text
                        content = json.dumps(content)
                else:
                    # a bare JSON document is its own content
                    content = raw
                entries.append((name, DataFile(name=name, content=content), None))
            except Exception as e:  # a line that does not decode quarantines
                writer.writeln_err(f"skipping {name}: {e}")
                rec = quarantine_record(name, "read", e)
                err_box[0] += 1
                err_box[1].append(rec)
                entries.append((name, None, rec))
        return entries

    def _follow_eval(self, data_files, rule_files, writer, err_box):
        """One micro-batch through the planes of a sweep chunk (the
        cache partition, the packed dispatch, the rim fold, the
        oracle), returning per-document outcomes (None = quarantined)
        aligned with `data_files`."""
        if not data_files:
            return []
        ctx = self._cache_lookup(data_files, rule_files)
        delta_files, _ = self._cache_subset(ctx, data_files, None)
        per_doc: List[Dict[str, Status]] = [dict() for _ in delta_files]
        vec_box: dict = {}
        if self.backend == "tpu":
            err_box[0] += self._eval_tpu(
                delta_files, rule_files, per_doc, writer, err_box, vec_box=vec_box,
            )
        else:
            err_box[0] += self._eval_oracle(
                delta_files, rule_files, None, per_doc, writer, err_box
            )
        return self._merge_outcomes(data_files, ctx, delta_files, per_doc, vec_box)

    def _parse_rules(self, writer: Writer):
        with _span("rule_parse"):
            rule_files: List[RuleFile] = []
            errors = 0
            for f in gather(self.rules, RULE_FILE_EXTENSIONS, self.last_modified):
                content = f.read_text()
                try:
                    rf = parse_rules_file(content, f.name)
                except ParseError as e:
                    # per-file error isolation
                    writer.writeln_err(f"Parse Error on ruleset file {f.name}")
                    writer.writeln_err(str(e))
                    errors += 1
                    continue
                if rf is not None:
                    rule_files.append(
                        RuleFile(name=f.name, full_name=str(f), content=content, rules=rf)
                    )
            return rule_files, errors

    # -- the three-stage pipeline (ingest workers >= 1) --------------
    def _run_pipeline(self, todo, rule_files, done, manifest_path,
                      writer, workers) -> int:
        """The three stages: (1) ingest: worker processes (or inline when
        workers == 1 or the pool cannot start) read and encode chunks
        into a bounded prefetch queue; (2) the packed dispatch; (3) the
        fold: chunk k-1's tallies while the card runs chunk k and the
        workers encode k+1..k+depth. Emission keeps the serial path's
        byte order. Returns the number of chunks evaluated."""
        from ..parallel.ingest import _chunk_job, pipeline_depth, shared_pool

        depth = pipeline_depth()
        # pool and restart state live in boxes so the crash recovery in
        # _take_ingest can restart (or retire) the pool mid-run
        pool_box = [None]
        restarts = [0]
        if workers >= 2 and len(todo) > 1:
            # the process-global pool; None (inline ingest) when it
            # cannot start
            pool_box[0] = shared_pool(workers)
        queue: list = []  # [(j, AsyncResult)], at most `depth` deep
        nxt = [0]

        def _top_up() -> None:
            # backpressure: never more than `depth` encoded chunks ahead
            # of the dispatch stage
            if pool_box[0] is None:
                return
            while nxt[0] < len(todo) and len(queue) < depth:
                j2 = nxt[0]
                ci2, _sig2, chunk2 = todo[j2]
                queue.append((j2, pool_box[0].submit(
                    _chunk_job, (ci2, [str(p) for p in chunk2])
                )))
                nxt[0] += 1
                PIPELINE_COUNTERS["max_inflight_chunks"] = max(
                    PIPELINE_COUNTERS["max_inflight_chunks"], len(queue)
                )

        evaluated = 0
        inflight = None
        # the pool is process-global and not closed here: its spawn
        # cost amortizes across runs in one process, and abandoned
        # in-flight jobs drain harmlessly
        with manifest_path.open("a") as mf:
            _top_up()
            for j, (ci, sig, chunk) in enumerate(todo):
                if self._drain is not None and self._drain.tripped():
                    # graceful drain: stop feeding the pipeline; the
                    # in-flight chunk below still finishes and
                    # checkpoints
                    break
                cw = self._chunk_writer(writer, ci)
                data_files, encoded, pre_err, pre_recs = self._take_ingest(
                    j, chunk, queue, pool_box, cw,
                    busy=inflight is not None,
                    workers=workers, nxt=nxt, restarts=restarts,
                )
                _top_up()
                err_box = [pre_err, pre_recs]
                # the workers encoded the whole chunk; the partition
                # subsets it so only the delta reaches dispatch
                ctx = self._cache_lookup(data_files, rule_files)
                delta_files, encoded = self._cache_subset(ctx, data_files, encoded)
                state = self._dispatch_tpu(
                    delta_files, rule_files, cw, err_box,
                    encoded=encoded, vec_box={},
                )
                if inflight is not None:
                    ci_prev, rec = self._finish_chunk(
                        inflight, self._chunk_writer(writer, inflight[0])
                    )
                    self._checkpoint(ci_prev, rec, writer, mf, done)
                    evaluated += 1
                inflight = (ci, sig, chunk, data_files, ctx, delta_files,
                            state, err_box)
            if inflight is not None:
                ci_prev, rec = self._finish_chunk(
                    inflight, self._chunk_writer(writer, inflight[0])
                )
                self._checkpoint(ci_prev, rec, writer, mf, done)
                evaluated += 1
        return evaluated

    def _take_ingest(self, j, chunk, queue, pool_box, writer, busy,
                     workers=0, nxt=None, restarts=None):
        """Dequeue chunk j's worker-encoded payload, or read and encode
        it inline (workers == 1, no pool, or a failed worker job).
        Returns (data_files, (groups, oversize, interner), error_count,
        quarantine_records); the chunk's read and encode messages go to
        `writer` here, where the serial path's prefetch emits them.

        A dead or hung worker (bounded by GUARD_TPU_INGEST_CHUNK_TIMEOUT)
        starts the recovery ladder: the chunk retries inline at once, the
        jobs queued on the dead pool are re-planned, and the pool
        restarts with a bounded exponential backoff."""
        import time

        pool = pool_box[0]
        if pool is not None and queue and queue[0][0] == j:
            _jj, handle = queue.pop(0)
            t0 = time.perf_counter()
            try:
                maybe_fail("worker_crash")
                _ci, res = handle.get(timeout=_chunk_timeout())
            except Exception as e:  # the worker died or hung: recover
                res = None
                self._recover_ingest(e, queue, pool_box, workers, nxt, restarts)
            PIPELINE_COUNTERS["ingest_stall_seconds"] += time.perf_counter() - t0
            if res is not None:
                from ..ops.encoder import Interner, batch_from_payload

                PIPELINE_COUNTERS["chunks_prefetched"] += 1
                if busy:
                    # encoded in a worker while the previous chunk's
                    # device work was in flight
                    PIPELINE_COUNTERS["encode_dispatch_overlap"] += 1
                PIPELINE_COUNTERS["read_parse_seconds"] += res["read_seconds"]
                PIPELINE_COUNTERS["encode_seconds"] += res["encode_seconds"]
                _ingest_worker_spans(res.get("spans"), chunk=j)
                data_files = [
                    DataFile(name=n, content=c)
                    for n, c in zip(res["names"], res["contents"])
                ]
                for i in res["pv_failed"]:
                    data_files[i]._pv_failed = True
                for m in res["messages"]:
                    writer.writeln_err(m)
                encoded = (
                    [(batch_from_payload(p), idx) for p, idx in res["groups"]],
                    res["oversize"],
                    Interner.from_strings(res["strings"]),
                )
                return (data_files, encoded, res["errors"],
                        list(res.get("quarantined", ())))
        err_box = [0, []]
        t0 = time.perf_counter()
        data_files = self._read_chunk(chunk, writer, err_box)
        t_read = time.perf_counter() - t0
        encoded = self._encode_chunk(data_files, writer, err_box)
        PIPELINE_COUNTERS["read_parse_seconds"] += t_read
        PIPELINE_COUNTERS["encode_seconds"] += time.perf_counter() - t0 - t_read
        return data_files, encoded, err_box[0], err_box[1]

    def _recover_ingest(self, exc, queue, pool_box, workers, nxt,
                        restarts) -> None:
        """Ingest-worker crash recovery: log, count the inline retry,
        re-plan every chunk queued on the dead pool, and restart the
        pool (bounded exponential backoff, capped restarts)."""
        import time

        from ..parallel.ingest import restart_shared_pool

        ingest_log = logging.getLogger("guard_tpu_torch.ingest")
        ingest_log.warning("ingest worker failed (%s); retrying chunk inline", exc)
        FAULT_COUNTERS["retries"] += 1
        if queue:
            # jobs queued on the dead pool are lost: rewind the submit
            # cursor so _top_up re-plans them on the new pool
            if nxt is not None:
                nxt[0] = queue[0][0]
            queue.clear()
        if restarts is None:
            pool_box[0] = None
            return
        restarts[0] += 1
        if restarts[0] > _MAX_POOL_RESTARTS:
            ingest_log.warning(
                "ingest pool crashed %d times; staying inline for the "
                "rest of the run", restarts[0] - 1,
            )
            pool_box[0] = None
            return
        backoff = min(_retry_backoff() * (2 ** (restarts[0] - 1)), 2.0)
        if backoff > 0:
            time.sleep(backoff)
        FAULT_COUNTERS["worker_restarts"] += 1
        pool_box[0] = restart_shared_pool(workers)

    def _finish_chunk(self, inflight, writer):
        """Stage 3 for one chunk: collect the dispatched device work,
        run the oracle reruns, fold the tallies and build the manifest
        record, while the NEXT chunk's device work runs."""
        (ci, sig, chunk, data_files, ctx, delta_files, state,
         err_box) = inflight
        per_doc: List[Dict[str, Status]] = [dict() for _ in delta_files]
        errors = self._collect_tpu(state, per_doc, writer, err_box)
        return ci, self._chunk_record(
            ci, sig, chunk, data_files, ctx, delta_files, per_doc,
            state.get("vec_box") or {}, errors, err_box,
        )

    def _chunk_record(self, ci, sig, chunk, data_files, ctx, delta_files,
                      per_doc, vec_box, errors, err_box) -> dict:
        counts = {k: 0 for k in _STATUS_NAMES}
        failed: List[dict] = []
        errors += err_box[0]
        self._tally_chunk(data_files, ctx, delta_files, per_doc, vec_box, counts, failed)
        rec = {
            "chunk": ci,
            "sig": sig,
            "files": len(chunk),
            "first": chunk[0].name if chunk else None,
            "counts": counts,
            "failed": failed,
            "errors": errors,
        }
        if err_box[1]:
            rec["quarantined"] = err_box[1]
            FAULT_COUNTERS["quarantined_docs"] += len(err_box[1])
        return rec

    # -- one chunk ---------------------------------------------------
    def _read_chunk(self, chunk: List[Path], writer: Writer, err_box) -> List[DataFile]:
        """Read chunk files into DataFiles whose trees build lazily: on
        the card the encoder works from the raw text, and a tree is
        built only for the oracle and the function precompute."""
        data_files: List[DataFile] = []
        with _span("read_parse", {"files": len(chunk)}):
            for p in chunk:
                try:
                    maybe_fail("read", key=p.name)
                    content = p.read_text()
                    data_files.append(DataFile(name=p.name, content=content))
                except Exception as e:  # any unreadable file quarantines
                    writer.writeln_err(f"skipping {p}: {e}")
                    err_box[0] += 1
                    err_box[1].append(quarantine_record(p.name, "read", e))
        return data_files

    def _evaluate_chunk(self, ci: int, sig: str, chunk: List[Path], rule_files,
                        writer: Writer, prepared=None, prefetch=None) -> dict:
        errors = 0
        err_box = [0, []]
        if prepared is not None:
            # read and encoded by the prefetch (overlapped with the
            # previous chunk's device work); the cache partition ran
            # there, before the encode
            data_files, ctx, delta_files, encoded, pre_box = prepared
            err_box[0] += pre_box[0]
            err_box[1].extend(pre_box[1])
        else:
            data_files = self._read_chunk(chunk, writer, err_box)
            ctx = self._cache_lookup(data_files, rule_files)
            delta_files, _ = self._cache_subset(ctx, data_files, None)
            encoded = None

        per_doc: List[Dict[str, Status]] = [dict() for _ in delta_files]
        vec_box: dict = {}
        if self.backend == "tpu":
            errors += self._eval_tpu(
                delta_files, rule_files, per_doc, writer, err_box,
                encoded=encoded, after_dispatch=prefetch, vec_box=vec_box,
            )
        else:
            errors += self._eval_oracle(
                delta_files, rule_files, None, per_doc, writer, err_box
            )
        return self._chunk_record(ci, sig, chunk, data_files, ctx, delta_files,
                                  per_doc, vec_box, errors, err_box)

    # -- the result cache (cache/results.py) -------------------------
    def _cache_lookup(self, data_files, rule_files):
        """The cache partition of one chunk, before the encode: every
        document's key read in one batch. None when the cache is off or
        off the card, else a ctx dict: `cached` maps a document index to
        its replayed outcome, `delta_idx` lists the documents to encode
        and dispatch, `keys` the store addresses, and `fault_snap` the
        fault counters' level at partition time."""
        from ..cache import results as rcache

        if self.backend != "tpu" or not self.result_cache:
            return None
        from ..ops.plan import plan_digest

        pdig = plan_digest(rule_files, self._dev)
        cfg = rcache.config_hash(mode="sweep")
        keys = {
            di: rcache.result_key(pdig, rcache.doc_digest(df.content), cfg)
            for di, df in enumerate(data_files)
        }
        # no name guard: sweep outcomes are name-free (manifest rows and
        # the failed list take the name from the live file), so
        # same-content documents share one entry
        payloads = rcache.load_entries([(keys[di], None) for di in range(len(data_files))])
        cached: Dict[int, dict] = {}
        delta_idx: List[int] = []
        for di, payload in enumerate(payloads):
            out = payload.get("sweep") if payload else None
            if (
                isinstance(out, dict)
                and out.get("status") in _STATUS_NAMES
                and isinstance(out.get("fails"), list)
            ):
                cached[di] = out
            else:
                delta_idx.append(di)
        seen = self._delta_seen
        seen[0] += len(cached)
        seen[1] += len(delta_idx)
        rcache.set_delta_gauge(seen[1], seen[0] + seen[1])
        return {
            "cached": cached,
            "delta_idx": delta_idx,
            "keys": keys,
            "fault_snap": _fault_level(),
        }

    @staticmethod
    def _cache_subset(ctx, data_files, encoded):
        """The delta of a chunk: the files that must dispatch and, when
        the ingest workers already encoded the whole chunk, the matching
        rows of its bucket groups (indices renumbered over the delta)."""
        if ctx is None or not ctx["cached"]:
            return data_files, encoded
        delta_idx = ctx["delta_idx"]
        if not delta_idx:
            return [], None
        delta_files = [data_files[i] for i in delta_idx]
        if encoded is not None:
            import numpy as np

            from ..ops.encoder import take_doc_subset

            groups, oversize, interner = encoded
            pos = np.full(len(data_files), -1, dtype=np.int64)
            pos[delta_idx] = np.arange(len(delta_idx))
            sub_groups = []
            for batch, idx in groups:
                keep = np.nonzero(pos[idx] >= 0)[0]
                if len(keep):
                    sub_groups.append((take_doc_subset(batch, keep), pos[idx[keep]]))
            over = pos[np.asarray(oversize, dtype=np.int64)]
            encoded = (sub_groups, over[over >= 0], interner)
        return delta_files, encoded

    def _tally_chunk(self, data_files, ctx, delta_files, per_doc,
                     vec_box, counts, failed) -> None:
        """The fold of one chunk: per-document outcomes (the rim fold,
        or the scalar walk) merged with the cache hits in ORIGINAL
        document order, so counts, the failed list and the manifest row
        are the cache-off run's."""
        for df, out in zip(data_files, self._merge_outcomes(
                data_files, ctx, delta_files, per_doc, vec_box)):
            if out is None:
                continue
            counts[out["status"]] += 1
            if out["fails"]:
                failed.append({"data": df.name, "rules": out["fails"]})

    def _merge_outcomes(self, data_files, ctx, delta_files, per_doc, vec_box) -> list:
        """Every document's outcome in order: the delta's computed
        (stored back in one transaction, unless a document or the
        chunk's fault counters disqualify them), the rest replayed."""
        with _span("rim_reduce", {"docs": len(delta_files)}):
            if vec_box.get("active"):
                outcomes = self._outcomes_vectorized(delta_files, vec_box)
            else:
                outcomes = self._outcomes_scalar(delta_files, per_doc)
        if ctx is None:
            return outcomes
        self._cache_store(ctx, delta_files, outcomes, vec_box)
        if not ctx["cached"]:
            return outcomes
        delta_pos = {di: k for k, di in enumerate(ctx["delta_idx"])}
        return [
            ctx["cached"][di] if di in ctx["cached"] else outcomes[delta_pos[di]]
            for di in range(len(data_files))
        ]

    @staticmethod
    def _cache_store(ctx, delta_files, outcomes, vec_box) -> None:
        """Write back the freshly computed outcomes in one batch. Never
        stored: documents that quarantined (outcome None), documents the
        card did not cover or whose oracle pass raised (`nostore`), and
        every document of a chunk during which a fault counter moved.
        Deterministic unsure reruns do store: they give the same
        statuses on every run."""
        if not ctx["delta_idx"] or _fault_level() != ctx["fault_snap"]:
            return
        from ..cache import results as rcache

        nostore = vec_box.get("nostore") or ()
        entries = [
            (ctx["keys"][ctx["delta_idx"][pos]], {"name": df.name, "sweep": out})
            for pos, (df, out) in enumerate(zip(delta_files, outcomes))
            if out is not None and pos not in nostore
        ]
        if entries:
            rcache.store_entries(entries)

    @staticmethod
    def _outcomes_scalar(data_files, per_doc) -> list:
        """Per-document (status, fails) outcomes from the per-document
        status dicts (None for a document that did not parse)."""
        outcomes = []
        for df, statuses in zip(data_files, per_doc):
            if getattr(df, "_pv_failed", False):
                # unparseable doc: error counted, not tallied
                outcomes.append(None)
                continue
            doc_status = Status.SKIP
            for st in statuses.values():
                doc_status = doc_status.and_(st)
            fails = sorted(n for n, s in statuses.items() if s == Status.FAIL)
            outcomes.append({"status": doc_status.value.lower(), "fails": fails})
        return outcomes

    @staticmethod
    def _pv(df, writer, err_box):
        """Lazy document build: the encoder works from raw content, so
        the tree is built only for the oracle and the function
        precompute. A parse failure marks the document (excluded from
        the tallies) and counts one error."""
        if df._pv is None and not getattr(df, "_pv_failed", False):
            try:
                df._pv = load_document(df.content, df.name)
            except GuardError as e:
                df._pv_failed = True
                writer.writeln_err(f"skipping {df.name}: {e}")
                err_box[0] += 1
                err_box[1].append(quarantine_record(df.name, "parse", e))
        return df._pv

    def _padded_pvs(self, data_files, writer, err_box):
        """Trees of every file, an unparseable one replaced by a null
        stand-in (marked _pv_failed: its statuses are not tallied)."""
        from ..core.values import PV
        from ..core.values import Path as VPath

        pvs = [self._pv(df, writer, err_box) for df in data_files]
        return [pv if pv is not None else PV.null(VPath.root()) for pv in pvs]

    def _encode_chunk(self, data_files, writer, err_box):
        """Encode one chunk through ops.encoder.encode_chunk_texts (also
        the ingest workers' body, so the serial and worker paths cannot
        drift): the native encoder when the whole chunk sniffs as JSON
        (an invalid document is marked, quarantined and replaced by a
        null stand-in), the tree encoder otherwise. Returns (groups,
        oversize, interner)."""
        from ..ops.encoder import encode_chunk_texts

        groups, oversize, interner, pv_failed, messages, errors, recs, pvs = (
            encode_chunk_texts([df.name for df in data_files],
                               [df.content for df in data_files])
        )
        for i in pv_failed:
            data_files[i]._pv_failed = True
        if pvs is not None:
            # the tree path built the documents: keep them for the oracle
            for df, pv in zip(data_files, pvs):
                if pv is not None and df._pv is None:
                    df._pv = pv
        for m in messages:
            writer.writeln_err(m)
        err_box[0] += errors
        err_box[1].extend(recs)
        return groups, oversize, interner

    def _fnvar_encode(self, rf, data_files, interner, writer, err_box):
        """The function-variable path of one rules file: precompute its
        function values on the documents' trees (ops/fnvars.py) and
        encode them with the documents into `interner`. Returns (groups,
        host documents): beyond the last bucket, exotic numbers, or a
        function that raised (the oracle reruns those)."""
        from ..ops.encoder import encode_bucketed
        from ..ops.fnvars import precompute_fn_values

        pvs = self._padded_pvs(data_files, writer, err_box)
        fn_vars, fn_vals, fn_err = precompute_fn_values(rf.rules, pvs)
        groups, oversize, _ = encode_bucketed(
            pvs, interner, fn_values=fn_vals, fn_var_order=fn_vars
        )
        return groups, {int(i) for i in oversize} | set(fn_err)

    def _eval_tpu(self, data_files, rule_files, per_doc, writer, err_box,
                  encoded=None, after_dispatch=None, vec_box=None) -> int:
        """Dispatch, then collect: `after_dispatch` (the serial path's
        double buffer) runs with the packed device work in flight,
        between the two halves."""
        state = self._dispatch_tpu(
            data_files, rule_files, writer, err_box, encoded=encoded, vec_box=vec_box,
        )
        if after_dispatch is not None:
            after_dispatch()
        return self._collect_tpu(state, per_doc, writer, err_box)

    def _dispatch_tpu(self, data_files, rule_files, writer, err_box,
                      encoded=None, vec_box=None) -> dict:
        """Stage 2, the dispatch half: lower the registry (the plan
        layer, else per chunk) and dispatch the packs, returning with
        the device work IN FLIGHT on the evaluators' streams (no
        synchronization here), so the pipeline can fold chunk k-1 and
        encode chunk k+1 while the card runs chunk k."""
        from ..ops.backend import dispatch_packs
        from ..ops.fnvars import precomputable_fn_vars
        from ..ops.ir import compile_rules_file, pack_compatible
        from ..ops.plan import get_plan, relocate_batch
        from ..parallel import mesh2d

        state = {"vec_box": vec_box, "data_files": data_files}
        if not data_files:
            return state
        if encoded is None:
            encoded = self._encode_chunk(data_files, writer, err_box)
        groups, oversize, interner = encoded
        host_shared = {int(i) for i in oversize}

        # the plan layer: lower and pack the registry ONCE (the memo
        # across chunks, the disk artifact across runs) and relocate
        # each chunk's ids into the plan's namespace; --no-plan-cache
        # lowers every file per chunk against the chunk's interner
        prep = []
        plan = None
        if self.plan_cache:
            plan = get_plan(rule_files, verify=self.verify_plans, device=self._dev)
            relocate_batch(plan, [b for b, _ in groups], interner, verify=self.verify_plans)
            interner = plan.interner
            for fi, rf in enumerate(rule_files):
                f_groups, f_host = groups, host_shared
                compiled = plan.compiled[fi]
                if compiled is None:
                    # function variables: per chunk, against the plan's
                    # interner so ids stay in one namespace
                    with _span("lower_compile", {"files": 1, "mode": "fnvar"}):
                        f_groups, f_host = self._fnvar_encode(
                            rf, data_files, interner, writer, err_box
                        )
                        compiled = compile_rules_file(rf.rules, interner)
                prep.append((rf, f_groups, f_host, compiled))
        else:
            with _span("lower_compile", {"files": len(rule_files)}):
                for rf in rule_files:
                    f_groups, f_host = groups, host_shared
                    if precomputable_fn_vars(rf.rules):
                        f_groups, f_host = self._fnvar_encode(
                            rf, data_files, interner, writer, err_box
                        )
                    prep.append((rf, f_groups, f_host,
                                 compile_rules_file(rf.rules, interner)))

        vec_on = vec_box is not None and self.vector_rim
        state.update(groups=groups, prep=prep, vec_on=vec_on, pack_pending=None)
        if not self.pack_rules:
            return state
        items = [
            (fi, c) for fi, (_rf, g, _h, c) in enumerate(prep)
            if g is groups and pack_compatible(c) is None
        ]
        prepacked = plan.prepacked_items() if plan is not None else None
        if not (prepacked if prepacked is not None else len(items) >= 2):
            return state
        try:
            # the JAX grammar; every shape runs unsharded on one card
            mesh2d.resolve_mesh_shape(self.mesh_shape, mesh2d.device_count(self._dev))
        except ValueError as e:
            # a malformed --mesh-shape: the JAX package's warning and
            # its per-file fallback for the chunk
            log.warning("packed dispatch plane failed (%s); "
                        "falling back to per-file dispatch", e)
            FAULT_COUNTERS["dispatch_fallbacks"] += 1
            return state
        state["pack_pending"] = dispatch_packs(
            items, groups, len(data_files), oversize, self._dev,
            prepacked=prepacked, with_rim=vec_on, mesh_shape="off",
        )
        return state

    def _collect_tpu(self, state, per_doc, writer, err_box) -> int:
        """Stage 3, the collect half: wait for the dispatched packs (the
        `collect` span closes after the copies to the host), walk the
        files that are not in a pack, run the oracle reruns and fill
        per_doc or the vec_box records."""
        from ..ops.backend import collect_packs
        from ..ops.ir import FAIL, PASS, SKIP, build_rim_spec
        from ..parallel.device import DeviceBatchEvaluator, evaluate_groups

        data_files = state["data_files"]
        if not data_files:
            return 0
        _status = {PASS: Status.PASS, FAIL: Status.FAIL, SKIP: Status.SKIP}
        vec_box = state["vec_box"]
        vec_on = state["vec_on"]
        pending = state["pack_pending"]
        packed_results = collect_packs(pending) if pending is not None else {}
        # the group names of a packed file come from its pack's RimSpec
        pack_names = {}
        if pending is not None:
            for pack, _packed, spec, _ev, _handles in pending.pending:
                for k, (fi, _c) in enumerate(pack):
                    pack_names[fi] = spec.file_group_names[k]

        recs: list = []
        # documents the card did not cover and documents whose oracle
        # pass raised are never stored in the result cache
        nostore: set = set()
        D = len(data_files)
        errors = 0
        for fi, (rf, f_groups, f_host, compiled) in enumerate(state["prep"]):
            unsure = None
            host_docs = set()
            statuses = None
            rim = None
            if fi in packed_results:
                statuses, unsure, host_docs, rim = packed_results[fi]
            elif compiled.rules:
                ev = DeviceBatchEvaluator(compiled, self._dev)
                with _span("dispatch", {"mode": "per_file", "file": fi}):
                    statuses, unsure, host, _rim = evaluate_groups(
                        ev, len(compiled.rules), f_groups, (), D
                    )
                host_docs = set(f_host) | host
            names: list = []
            name_last = None
            has_device = statuses is not None
            if has_device and vec_on:
                if rim is not None:
                    # K3's last-rule-wins block, by meaning (the sixth
                    # of collect_packs' blocks), and the pack's names
                    name_last, names = rim[5], pack_names[fi]
                else:
                    spec = build_rim_spec([compiled.rules])
                    names = spec.file_group_names[0]
                    name_last = statuses[:, spec.last_ids]
            elif statuses is not None:
                for di in range(D):
                    if di in host_docs:
                        continue
                    for ri, crule in enumerate(compiled.rules):
                        per_doc[di][crule.name] = _status[int(statuses[di, ri])]
            # the oracle's writes: a per-file dict list under the rim
            # fold (replayed after the device names, file by file),
            # straight into per_doc on the scalar path
            target = [dict() for _ in data_files] if vec_on else per_doc
            # documents the card did not hold: the oracle evaluates
            # every rule for them, so the host-rules pass excludes them
            if host_docs:
                nostore |= {int(i) for i in host_docs}
                errors += self._eval_oracle(
                    data_files, [rf], {"only_docs": host_docs}, target,
                    writer, err_box, bad_docs=nostore,
                )
            # rules the card cannot run, on every other document
            if compiled.host_rules:
                rest = set(range(D)) - host_docs
                if rest:
                    errors += self._eval_oracle(
                        data_files, [rf],
                        {"only_rules": {r.rule_name for r in compiled.host_rules},
                         "only_docs": rest},
                        target, writer, err_box, bad_docs=nostore,
                    )
            if unsure is not None:
                oracle_docs = {int(di) for di in unsure.any(axis=1).nonzero()[0]}
                if oracle_docs:
                    # unsure reruns are the designed precision ladder,
                    # deterministic, so their outcomes store; only
                    # reruns that raise join nostore
                    errors += self._eval_oracle(
                        data_files, [rf], {"only_docs": oracle_docs},
                        target, writer, err_box, bad_docs=nostore,
                    )
            if vec_on:
                recs.append((names, name_last, has_device, set(host_docs), target))
        if vec_box is not None:
            vec_box["active"] = vec_on
            vec_box["files"] = recs
            vec_box["nostore"] = nostore
        return errors

    @staticmethod
    def _outcomes_vectorized(data_files, vec_box) -> list:
        """Per-document (status, fails) outcomes from the per-file
        last-rule-wins blocks: the status is the lattice fold over each
        rule name's WINNING value (the dict-overwrite order: later files
        beat earlier ones, the last same-name rule beats previous ones,
        as the scalar fill). Documents an oracle touched replay the dict
        build (device names first, then that file's oracle writes, file
        by file); the rest fold as one numpy pass. None for a document
        that did not parse."""
        import numpy as np

        from ..ops.ir import FAIL

        _st = {0: Status.PASS, 1: Status.FAIL, 2: Status.SKIP}
        recs = vec_box["files"]
        D = len(data_files)
        replay = set()
        for _names, _nl, _hasdev, host_docs_f, owrites_f in recs:
            replay |= {int(i) for i in host_docs_f}
            replay.update(di for di in range(D) if owrites_f[di])
        # the winning (file, group) per rule name for the clean documents
        winner: Dict[str, tuple] = {}
        for fp, (names, _nl, has_device, _hd, _ow) in enumerate(recs):
            if has_device:
                for g, n in enumerate(names):
                    winner[n] = (fp, g)
        wnames = list(winner)
        doc_prio = None
        M = None
        if wnames:
            M = np.stack([recs[fp][1][:, g] for fp, g in winner.values()], axis=1)
            # PASS=0, FAIL=1, SKIP=2 -> priority SKIP < PASS < FAIL
            prio = np.array([1, 2, 0], np.int8)[M]
            doc_prio = prio.max(axis=1)
        outcomes = []
        for di, df in enumerate(data_files):
            if getattr(df, "_pv_failed", False):
                outcomes.append(None)
                continue
            if di in replay:
                d: Dict[str, Status] = {}
                for names, name_last, has_device, host_docs_f, owrites_f in recs:
                    if has_device and di not in host_docs_f:
                        for g, n in enumerate(names):
                            d[n] = _st[int(name_last[di, g])]
                    d.update(owrites_f[di])
                doc_status = Status.SKIP
                for st in d.values():
                    doc_status = doc_status.and_(st)
                status = doc_status.value.lower()
                fails = sorted(n for n, s in d.items() if s == Status.FAIL)
            else:
                p = int(doc_prio[di]) if doc_prio is not None else 0
                status = ("skip", "pass", "fail")[p]
                fails = []
                if p == 2:
                    fails = sorted(wnames[c] for c in np.nonzero(M[di] == FAIL)[0])
            outcomes.append({"status": status, "fails": fails})
        return outcomes

    def _eval_oracle(self, data_files, rule_files, restrict, per_doc, writer,
                     err_box, bad_docs=None) -> int:
        """The CPU evaluator over (restricted) documents and rules,
        writing each rule's status into per_doc."""
        from .report import rule_statuses_from_root

        only_docs = restrict.get("only_docs") if restrict else None
        only_rules = restrict.get("only_rules") if restrict else None
        errors = 0
        with _span("oracle", {"docs": len(only_docs) if only_docs is not None
                              else len(data_files)}):
            for rf in rule_files:
                for di, df in enumerate(data_files):
                    if only_docs is not None and di not in only_docs:
                        continue
                    pv = self._pv(df, writer, err_box)
                    if pv is None:
                        continue
                    try:
                        maybe_fail("oracle", key=df.name)
                        scope = RootScope(rf.rules, pv)
                        eval_rules_file(rf.rules, scope, df.name)
                    except GuardError as e:
                        writer.writeln_err(f"{df.name} vs {rf.name}: {e}")
                        errors += 1
                        # an oracle-errored document is incomplete: its
                        # stderr line must re-emit on every run, so it
                        # never enters the result cache
                        if bad_docs is not None:
                            bad_docs.add(di)
                        continue
                    statuses = rule_statuses_from_root(scope.reset_recorder().extract())
                    for rn, st in statuses.items():
                        if only_rules is not None and rn not in only_rules:
                            continue
                        per_doc[di][rn] = st
        return errors
