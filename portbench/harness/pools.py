"""Jobs for every worker of a process pool the program started.

A pool hands a job to whichever worker is free, so `each_worker`
submits rounds of jobs that linger a moment after their work, until
every worker has answered one.
"""

from __future__ import annotations

import os
import time


def _linger(job) -> tuple:
    fn, args = job
    out = fn(args)
    time.sleep(0.2)
    return os.getpid(), out


def each_worker(pool, workers: int, fn, args, timeout: float = 120.0) -> dict:
    """pid -> fn(args), run in every worker of `pool` (an object with
    `submit(fn, args)` returning an async result); fewer pids when some
    worker never answered within `timeout` seconds. `fn` must be a
    module-level function that the workers can import."""
    seen: dict = {}
    deadline = time.monotonic() + timeout
    while len(seen) < workers and time.monotonic() < deadline:
        jobs = [pool.submit(_linger, (fn, args)) for _ in range(2 * workers)]
        for job in jobs:
            pid, out = job.get(timeout=max(1.0, deadline - time.monotonic()))
            seen[pid] = out
    return seen
