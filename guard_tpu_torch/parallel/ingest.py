"""Parallel host ingest: the document encode over a pool of workers.

The port of the validate half of guard_tpu/parallel/ingest.py. The
document list splits into contiguous shards; each worker encodes its
shard with a private interner into per-size-bucket groups (the native
encoder when the whole corpus sniffs as JSON, else the tree loader and
`encode_bucketed`), and the shards merge through an intern-id remap
(`ops.encoder.remap_interned_ids`, `merge_bucket_groups`). Statuses and
reports do not depend on intern-id labels, so the output equals the
serial encode's.

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
from typing import List, Optional

log = logging.getLogger("guard_tpu_torch.ingest")

#: auto worker ceiling: ingest rarely scales past a few processes
#: before the device stages are the bottleneck again
DEFAULT_MAX_WORKERS = 4

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
