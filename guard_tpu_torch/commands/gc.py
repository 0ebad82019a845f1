"""The `gc` command: crash-safe store hygiene for the persistent caches.

The port's copy of guard_tpu/commands/gc.py, over the port's three
stores: the compiled-plan artifacts (`ops/plan.py`, a `*.plan` pickle and
a `*.sigs.json` sidecar per registry), the result database
(`cache/results.py`, one SQLite file) and the sweep chunk journals
(`utils/journal.py`, a `*.journal.jsonl` per run). Every writer treats
its store as an optimization and never deletes, so under a CI fleet the
stores grow without bound; `gc` is the other half of that contract:

* **Size-capped LRU eviction**: each store is capped at `--max-bytes`
  (default 1 GiB; the port has no GUARD_TPU_CACHE_MAX_BYTES twin). In
  the file stores eviction is mtime-ordered, oldest first: nothing
  refreshes an entry on read, so mtime order is insertion order. In the
  result database the oldest rows go first by `rowid`: `INSERT OR
  REPLACE` gives a rewritten row a new rowid, so rowid order is
  insertion order too; the freed pages are then reclaimed (VACUUM), and
  a database whose every row goes is deleted. A database file that is
  not one is a single entry (the next store replaces it anyway).
  Deletion is crash-safe: a file entry is whole (tmp + `os.replace`),
  and the database deletes in one transaction.

* **Orphan-tmp reaping**: a writer killed between its tmp write and
  `os.replace` leaves a `*.tmp.<pid>` file no load path reads. Only
  orphans older than a grace period (`_TMP_GRACE_S`) are reaped: a
  younger one may belong to a live writer mid-rename.

* **Always exit 0**: hygiene is advisory. An entry that vanishes
  mid-evict is skipped; one that cannot be deleted counts in
  `gc.evict_errors`; neither fails the command.

One JSON summary line reports per-store bytes before and after and the
eviction and reap counts, under the JAX package's keys; `--dry-run`
reports without deleting.
"""

from __future__ import annotations

import json
import logging
import sqlite3
import time
from contextlib import closing
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

from ..utils.io import Reader, Writer
from ..utils.telemetry import GC_COUNTERS
from ..utils.telemetry import span as _span

log = logging.getLogger("guard_tpu_torch.gc")

#: default per-store size cap when --max-bytes is not given
_DEFAULT_MAX_BYTES = 1 << 30

#: a *.tmp.<pid> younger than this may belong to a live writer mid
#: rename: leave it alone (tests age orphans with os.utime)
_TMP_GRACE_S = 300.0


def cache_max_bytes(flag: Optional[int] = None) -> int:
    """The per-store byte cap: the flag, else 1 GiB."""
    return _DEFAULT_MAX_BYTES if flag is None else max(0, int(flag))


def _store_dirs() -> List[Tuple[str, Path, Tuple[str, ...]]]:
    """(name, directory, entry glob patterns) for every store gc owns.
    Globs are explicit: gc must never eat a file some other tool parked
    in a shared cache directory."""
    from ..cache.results import DB_NAME, result_cache_dir
    from ..ops.plan import plan_cache_dir
    from ..utils.journal import journal_dir

    return [
        ("plan", plan_cache_dir(), ("*.plan", "*.sigs.json")),
        ("result", result_cache_dir(), (DB_NAME,)),
        ("journal", journal_dir(), ("*.journal.jsonl",)),
    ]


def _entries(root: Path, patterns: Tuple[str, ...]) -> List[Tuple[float, int, Path]]:
    """(mtime, size, path) per store entry; stat failures (an entry
    vanishing under a concurrent writer) are simply not entries."""
    out: List[Tuple[float, int, Path]] = []
    for pat in patterns:
        for p in root.glob(pat):
            try:
                st = p.stat()
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, p))
    return out


def _db_rows(path: Path) -> Optional[List[Tuple[int, int]]]:
    """(rowid, bytes) of every row of the result database, oldest
    first, or None when the file is not a readable database."""
    try:
        with closing(sqlite3.connect(str(path), timeout=60)) as conn:
            return list(conn.execute(
                "SELECT rowid, length(key) + length(blob) FROM entries ORDER BY rowid"
            ))
    except sqlite3.Error:
        return None


def _db_delete(path: Path, last_rowid: int) -> int:
    """Delete the rows up to `last_rowid`, reclaim the space, and
    return the file's new size."""
    with closing(sqlite3.connect(str(path), timeout=60)) as conn:
        with conn:
            conn.execute("DELETE FROM entries WHERE rowid <= ?", (last_rowid,))
        conn.execute("VACUUM")
    return path.stat().st_size


@dataclass
class Gc:
    max_bytes: Optional[int] = None
    dry_run: bool = False

    def execute(self, writer: Writer, reader: Reader) -> int:
        cap = cache_max_bytes(self.max_bytes)
        GC_COUNTERS["runs"] += 1
        stores = {}
        with _span("gc", {"cap": cap}):
            for name, root, patterns in _store_dirs():
                stores[name] = self._sweep_store(name, root, patterns, cap)
        writer.writeln(json.dumps({
            "gc": stores,
            "max_bytes": cap,
            "dry_run": self.dry_run,
        }))
        return 0

    def _sweep_store(self, name: str, root: Path, patterns: Tuple[str, ...],
                     cap: int) -> dict:
        report = {
            "dir": str(root),
            "bytes_before": 0,
            "bytes_after": 0,
            "evicted": 0,
            "tmps_reaped": 0,
        }
        if not root.is_dir():
            return report
        self._reap_orphans(root, report)
        entries = _entries(root, patterns)
        total = sum(size for _, size, _ in entries)
        report["bytes_before"] = total
        if name == "result":
            # one database file: rows, not files, are the entries
            for _mtime, size, path in entries:
                total = self._sweep_db(path, size, total, cap, report)
            report["bytes_after"] = total
            return report
        # LRU = oldest mtime first; ties break on path for determinism
        entries.sort(key=lambda e: (e[0], str(e[2])))
        for _mtime, size, path in entries:
            if total <= cap:
                break
            if not self._unlink(path):
                continue
            total -= size
            report["evicted"] += 1
            if not self.dry_run:
                GC_COUNTERS["files_evicted"] += 1
                GC_COUNTERS["bytes_evicted"] += size
        report["bytes_after"] = total
        return report

    def _sweep_db(self, path: Path, size: int, total: int, cap: int,
                  report: dict) -> int:
        """Evict the database's oldest rows until the store fits `cap`;
        returns the store's new total. Each row's share of the file
        estimates what a VACUUM frees, and a round that leaves the file
        above the cap evicts again from the new size."""
        if total <= cap:
            return total
        rows = _db_rows(path)
        if rows is None:
            # not a database: one entry, evicted whole
            log.warning("result database %s is unreadable; evicting the file", path)
            if self._unlink(path):
                report["evicted"] += 1
                if not self.dry_run:
                    GC_COUNTERS["files_evicted"] += 1
                    GC_COUNTERS["bytes_evicted"] += size
                return total - size
            return total
        pos = 0
        while total > cap and pos < len(rows):
            # a row's share of the file: its bytes scaled by the file's
            # size over the live rows' bytes (pages and indexes included)
            scale = size / max(1, sum(b for _r, b in rows[pos:]))
            need, k = total - cap, pos
            freed = 0
            while k < len(rows) and freed < need:
                freed += rows[k][1] * scale
                k += 1
            if k == len(rows):
                # every row goes: the whole file goes
                if not self._unlink(path):
                    return total
                n = len(rows) - pos
                report["evicted"] += n
                if not self.dry_run:
                    GC_COUNTERS["files_evicted"] += n
                    GC_COUNTERS["bytes_evicted"] += size
                return total - size
            n = k - pos
            if self.dry_run:
                new_size = size - int(freed)
            else:
                try:
                    new_size = _db_delete(path, rows[k - 1][0])
                except (sqlite3.Error, OSError) as e:
                    log.warning("result database %s: eviction failed (%s)", path, e)
                    GC_COUNTERS["evict_errors"] += 1
                    return total
                GC_COUNTERS["files_evicted"] += n
                GC_COUNTERS["bytes_evicted"] += size - new_size
            report["evicted"] += n
            total -= size - new_size
            size, pos = new_size, k
        return total

    def _unlink(self, path: Path) -> bool:
        """Delete one entry (not under --dry-run): False when it could
        not be deleted (counted, skipped); an entry already gone counts
        as deleted, its bytes are gone either way."""
        if self.dry_run:
            return True
        try:
            path.unlink()
        except FileNotFoundError:
            pass
        except OSError:
            GC_COUNTERS["evict_errors"] += 1
            return False
        return True

    def _reap_orphans(self, root: Path, report: dict) -> None:
        now = time.time()
        for p in root.glob("*.tmp.*"):
            try:
                if now - p.stat().st_mtime < _TMP_GRACE_S:
                    continue  # possibly a live writer mid-rename
                if not self.dry_run:
                    p.unlink()
            except OSError:
                continue
            report["tmps_reaped"] += 1
            if not self.dry_run:
                GC_COUNTERS["orphan_tmps_reaped"] += 1
