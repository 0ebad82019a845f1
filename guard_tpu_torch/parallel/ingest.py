"""Parallel host ingest: the document encode over a pool of workers.

The port of guard_tpu/parallel/ingest.py, for the two commands that use
it:

* `validate`: the document list splits into contiguous shards; each
  worker encodes its shard with a private interner into per-size-bucket
  groups (the native encoder when the whole corpus sniffs as JSON, else
  the tree loader and `encode_bucketed`), and the shards merge through
  an intern-id remap (`ops.encoder.remap_interned_ids`,
  `merge_bucket_groups`). Statuses and reports do not depend on
  intern-id labels, so the output equals the serial encode's.
* `sweep`: stage 1 of the chunk pipeline (commands/sweep.py). A worker
  reads one chunk's files (`read_paths`, where the `read` fault point
  fires) and encodes them (`ops.encoder.encode_chunk_texts`) into the
  chunk's own bucket groups and interner (`_chunk_job`); the parent
  keeps at most `pipeline_depth()` chunks queued ahead of the device
  and restarts a pool whose worker died (`restart_shared_pool`).

* the 2-D mesh (parallel/mesh2d.py): `ShardPrefetcher`, a thread that
  cuts doc shard s+1 out of the bucketed encode while shard s runs on
  the cards.

Workers are spawned, never forked (a fork would inherit the parent's
CUDA context), and import neither torch nor JAX: a job touches only
numpy, the encoder and the tree loader. A script that starts the pool
must guard its body with `if __name__ == "__main__":`, since a spawned
worker re-imports the main module. A pool that cannot start degrades to
the serial encode with a logged warning; this is host work, so it hides
neither the device nor a kernel.
"""

from __future__ import annotations

import atexit
import logging
import os
import time
from typing import List, Optional, Tuple

log = logging.getLogger("guard_tpu_torch.ingest")

#: auto worker ceiling: ingest rarely scales past a few processes
#: before the device stages are the bottleneck again
DEFAULT_MAX_WORKERS = 4

#: bounded prefetch depth: at most this many encoded chunks may exist
#: ahead of the dispatch stage (backpressure bounds peak host memory at
#: depth x chunk columns). Override with GUARD_TPU_INGEST_DEPTH.
DEFAULT_DEPTH = 2


def pipeline_depth() -> int:
    raw = os.environ.get("GUARD_TPU_INGEST_DEPTH", "").strip()
    try:
        depth = int(raw) if raw else DEFAULT_DEPTH
    except ValueError:
        depth = DEFAULT_DEPTH
    return max(2, depth)

#: seconds a new pool has to answer its first ping (a worker that
#: cannot bootstrap would otherwise be respawned forever)
SPAWN_PROBE_TIMEOUT = 60.0


def resolve_ingest_workers(flag: Optional[int] = None) -> int:
    """Worker count: the flag wins, then `GUARD_TPU_INGEST_WORKERS` (the
    JAX package's variable, so one environment puts both packages in
    one state), then auto (cpu_count - 1, capped at
    DEFAULT_MAX_WORKERS). 0 and 1 encode in this process."""
    if flag is None:
        env = os.environ.get("GUARD_TPU_INGEST_WORKERS", "").strip()
        if env:
            try:
                flag = int(env)
            except ValueError:
                flag = None
    if flag is None:
        flag = min((os.cpu_count() or 1) - 1, DEFAULT_MAX_WORKERS)
    return max(0, int(flag))


def read_paths(paths: List[str]) -> Tuple[list, list, list, int, list]:
    """Read chunk files; unreadable ones are skipped with one error
    each (the sweep's `_read_chunk` contract, message-identical) and a
    structured quarantine record. Returns (names, contents, messages,
    errors, quarantine records)."""
    from ..utils.faults import maybe_fail, quarantine_record

    names, contents, msgs, errors, recs = [], [], [], 0, []
    for p in paths:
        base = os.path.basename(p)
        try:
            maybe_fail("read", key=base)
            with open(p, "r") as f:
                contents.append(f.read())
        except Exception as e:  # any unreadable file quarantines
            msgs.append(f"skipping {p}: {e}")
            errors += 1
            recs.append(quarantine_record(base, "read", e))
            continue
        names.append(base)
    return names, contents, msgs, errors, recs


def _chunk_job(args):
    """Worker body for one sweep chunk: read, then encode into the
    chunk's bucket groups (encoder.encode_chunk_texts), returning a
    picklable payload: the groups' columns (batch_payload) with their
    document indices, the oversize documents, the interner's strings,
    the failed documents' marks, messages and quarantine records, and
    the read and encode seconds."""
    ci, paths = args
    from ..ops.encoder import batch_payload, encode_chunk_texts
    from ..utils.telemetry import worker_spans

    t0 = time.perf_counter()
    w0 = time.time()
    names, contents, read_msgs, read_errs, read_recs = read_paths(paths)
    t_read = time.perf_counter() - t0
    groups, oversize, interner, pv_failed, enc_msgs, enc_errs, enc_recs, _pvs = (
        encode_chunk_texts(names, contents)
    )
    t_enc = time.perf_counter() - t0 - t_read
    return ci, {
        "names": names,
        "contents": contents,
        "groups": [(batch_payload(b), idx) for b, idx in groups],
        "oversize": oversize,
        "strings": interner.strings,
        "pv_failed": pv_failed,
        "messages": read_msgs + enc_msgs,
        "errors": read_errs + enc_errs,
        "quarantined": read_recs + enc_recs,
        "read_seconds": t_read,
        "encode_seconds": t_enc,
        # wall-anchored span records for the parent's trace (dropped
        # there when tracing is off)
        "spans": worker_spans([
            ("read_parse", w0, t_read),
            ("encode", w0 + t_read, t_enc),
        ]),
    }


def _validate_shard_job(args):
    """Worker body for one validate shard: encode a contiguous slice of
    the document list with a private interner into bucket groups — the
    native encoder when the whole corpus sniffed as JSON (decided in
    the parent, so every shard agrees with the serial path), the tree
    loader otherwise. A tree-loader parse failure reports the shard's
    first failing document instead (the serial path raises there with
    the same message). Returns ("ok", [(batch payload, doc indices)],
    oversize, strings, stats) or ("parse_error", index, message)."""
    names, contents, use_native = args
    from ..ops.encoder import batch_payload, encode_bucketed
    from ..utils.telemetry import worker_spans

    t0 = time.perf_counter()
    w0 = time.time()
    enc = None
    native = False
    if use_native:
        from ..ops.native_encoder import encode_json_bucketed, native_available

        if native_available():
            groups, oversize, interner, err = encode_json_bucketed(contents)
            if err is None:
                enc = groups, oversize, interner
                native = True
    if enc is None:
        from ..core.errors import GuardError
        from ..core.loader import load_document

        pvs = []
        for i, content in enumerate(contents):
            try:
                pvs.append(load_document(content, names[i]))
            except GuardError as e:
                return ("parse_error", i, str(e))
        enc = encode_bucketed(pvs)
    groups, oversize, interner = enc
    encode_s = time.perf_counter() - t0
    stats = {
        "encode_s": encode_s,
        "native": native,
        "rss_kb": _rss_kb(),
        # wall-anchored span records for the parent's trace (dropped
        # there when tracing is off)
        "spans": worker_spans([("encode", w0, encode_s)]),
    }
    return ("ok", [(batch_payload(b), idx) for b, idx in groups], oversize,
            interner.strings, stats)


def _rss_kb() -> int:
    """This process's resident set in KiB (0 where /proc does not give
    it): read at the end of a shard, when its columns are all built."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024
    except (OSError, ValueError, IndexError):
        return 0


def _spawn_pool(workers: int):
    """Isolated so tests can force a spawn failure."""
    import multiprocessing as mp

    return mp.get_context("spawn").Pool(processes=workers)


def _ping_job(x):
    return x


class IngestPool:
    """A spawn pool with graceful degradation: a construction failure
    leaves `.available` False and the caller encodes serially.

    Construction probes the pool with a bounded ping: under an embedder
    whose unguarded __main__ cannot re-execute under spawn, workers die
    during bootstrap and the pool respawns them forever, so an unprobed
    first result would hang rather than raise."""

    def __init__(self, workers: int):
        self.error: Optional[str] = None
        try:
            self._pool = _spawn_pool(workers)
        except Exception as e:  # any bootstrap failure degrades
            self._pool = None
            self.error = str(e)
            return
        try:
            got = self._pool.apply_async(_ping_job, (1,)).get(timeout=SPAWN_PROBE_TIMEOUT)
            if got != 1:
                raise RuntimeError(f"ping answered {got!r}")
        except Exception as e:
            self.error = f"spawn probe failed: {e!r}"
            self.close()

    @property
    def available(self) -> bool:
        return self._pool is not None

    def submit(self, fn, args):
        return self._pool.apply_async(fn, (args,))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


# one healthy pool per worker count serves the whole process: spawning
# costs about a second a worker. A spawn failure is remembered too, so
# degraded runs pay the probe and its warning once per process.
_POOL_CACHE: dict = {}
_SPAWN_FAILED: dict = {}


def shared_pool(workers: int) -> Optional[IngestPool]:
    """A cached healthy IngestPool of `workers`, or None when spawning
    fails (the failure is remembered). Callers must not close the pool;
    `close_shared_pools` does."""
    pool = _POOL_CACHE.get(workers)
    if pool is not None and pool.available:
        return pool
    if workers in _SPAWN_FAILED:
        return None
    _POOL_CACHE.pop(workers, None)
    pool = IngestPool(workers)
    if not pool.available:
        _SPAWN_FAILED[workers] = pool.error
        log.warning(
            "ingest worker pool unavailable (%s); "
            "falling back to inline ingest", pool.error,
        )
        return None
    if not _POOL_CACHE:
        atexit.register(close_shared_pools)
    _POOL_CACHE[workers] = pool
    return pool


def restart_shared_pool(workers: int) -> Optional[IngestPool]:
    """Tear down the cached pool of `workers` (a worker died) and spawn
    a fresh one; a remembered spawn failure is retried, since a restart
    is an explicit recovery step."""
    pool = _POOL_CACHE.pop(workers, None)
    if pool is not None:
        pool.close()
    _SPAWN_FAILED.pop(workers, None)
    return shared_pool(workers)


def close_shared_pools() -> None:
    for pool in list(_POOL_CACHE.values()):
        pool.close()
    _POOL_CACHE.clear()
    _SPAWN_FAILED.clear()


def parallel_encode_documents(names: List[str], contents: List[str], workers: int):
    """Validate's one-shot encode over the ingest pool.

    Returns (groups, oversize, interner, stats) — groups and oversize as
    ops.encoder.encode_bucketed returns them for the whole list — or
    None when the pool is unavailable (the caller encodes serially). A
    document the tree loader cannot parse raises GuardError with the
    first failing document's message in document order, the serial
    path's error. `stats`: the shards' encode seconds, whether each ran
    the native encoder, the largest worker's resident set at the end of
    its shard (KiB) and the seconds of the merge."""
    import numpy as np

    from ..commands.validate import _looks_json
    from ..core.errors import GuardError
    from ..ops.encoder import (
        Interner,
        batch_from_payload,
        merge_bucket_groups,
        remap_interned_ids,
    )

    n = len(contents)
    workers = min(workers, n)
    if workers < 2:
        return None
    use_native = all(_looks_json(c) for c in contents)
    pool = shared_pool(workers)
    if pool is None:
        return None
    bounds = [(n * k) // workers for k in range(workers + 1)]
    spans = [(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
    try:
        results = [
            h.get() for h in [
                pool.submit(_validate_shard_job, (names[lo:hi], contents[lo:hi], use_native))
                for lo, hi in spans
            ]
        ]
    except Exception as e:
        log.warning("ingest workers failed (%s); encoding serially", e)
        return None
    from ..utils.telemetry import ingest_worker_spans

    for res in results:
        if res[0] == "parse_error":
            # shards are contiguous and in document order, so the
            # earliest shard's first failure is the global first
            raise GuardError(res[2])
    for res in results:
        ingest_worker_spans(res[4].pop("spans", None))
    t0 = time.perf_counter()
    merged = Interner()
    shards = []
    for (lo, _hi), (_tag, payloads, oversize, strings, _stats) in zip(spans, results):
        remap = np.array([merged.intern(s) for s in strings], dtype=np.int32)
        groups = []
        for payload, idx in payloads:
            batch = batch_from_payload(payload)
            remap_interned_ids(batch, remap)
            groups.append((batch, idx))
        shards.append((groups, oversize, lo))
    groups, oversize = merge_bucket_groups(shards)
    stats = {
        "shards": [res[4] for res in results],
        "worker_max_rss_kb": max(res[4]["rss_kb"] for res in results),
        "merge_s": time.perf_counter() - t0,
    }
    return groups, oversize, merged, stats


class ShardPrefetcher:
    """Bounded host-side prefetch of the per-doc-shard dispatch inputs
    of the 2-D mesh (parallel/mesh2d.py).

    The mesh's dispatch loop (ops/backend.dispatch_packs) consumes one
    `(shard, lo, bucket_groups, oversize)` tuple per contiguous doc
    shard `(lo, hi)` of `bounds`. Producing it is host work: cutting
    the shard's rows out of each bucket of the encode
    (mesh2d.shard_groups). The dispatch is asynchronous on the cards'
    streams, so a producer thread prepares shard s+1 while shard s's
    walks run. The queue holds at most `pipeline_depth()` shards, and
    the `pipeline.shards_prefetched` / `shard_prefetch_stall_seconds`
    counters report how much overlap the thread bought. A batch of one
    shard never builds this class: the caller cuts it inline. The JAX
    package's prefetcher takes one batch and buckets each shard
    (split_batch_by_size); the port's encode is bucketed already, so it
    takes the groups and the oversize documents.
    """

    def __init__(self, groups, oversize, bounds, depth: Optional[int] = None):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth if depth else pipeline_depth())
        self._thread = threading.Thread(
            target=self._produce, args=(groups, oversize, list(bounds)),
            daemon=True, name="guard-tpu-shard-prefetch",
        )
        self._thread.start()

    def _produce(self, groups, oversize, bounds) -> None:
        from ..utils.telemetry import PIPELINE_COUNTERS
        from . import mesh2d

        try:
            for s, (lo, hi) in enumerate(bounds):
                sub_groups, over = mesh2d.shard_groups(groups, oversize, lo, hi)
                PIPELINE_COUNTERS["shards_prefetched"] += 1
                self._q.put(("ok", (s, lo, sub_groups, over)))
        except Exception as e:  # raised at the consumer's next get
            self._q.put(("error", e))
        else:
            self._q.put(("done", None))

    def __iter__(self):
        from ..utils.telemetry import PIPELINE_COUNTERS

        while True:
            t0 = time.perf_counter()
            kind, payload = self._q.get()
            PIPELINE_COUNTERS["shard_prefetch_stall_seconds"] += time.perf_counter() - t0
            if kind == "done":
                return
            if kind == "error":
                raise payload
            yield payload
