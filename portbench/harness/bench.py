"""One run of one cell: set-up, the measured window, the check.

`run` never looks for a card: run.py does, and refuses to go on without
one. Tests call `run` with device "cpu" to drive the rest of a run.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

from . import check as check_mod
from . import nojax, pools
from .record import Window


def cache_env(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds; nothing
    written to the user's ledger, and no fault armed from outside."""
    base = root / "build" / "portbench"
    os.environ["GUARD_TPU_TORCH_BUILD_DIR"] = str(base / "kernels")
    os.environ["GUARD_TPU_TORCH_NATIVE_DIR"] = str(base / "native")
    os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(base / "plans")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.pop("GUARD_TPU_LEDGER_DIR", None)
    os.environ.pop("GUARD_TPU_FAULT", None)


def _write_dir(args) -> str:
    """A pool worker's job: one directory of documents, from the
    generator in <pkg>/traffic/<generator>.py and the state (seed, k)."""
    import numpy as np

    from .spec import module

    pkg, generator, config, seed, k, first, n, d = args
    gen = module(Path(pkg), "traffic", generator)
    texts = gen.documents(config, np.random.default_rng([seed, k]), first, n)
    d = Path(d)
    d.mkdir(parents=True)
    for j, text in enumerate(texts):
        (d / f"doc{j:06d}.json").write_text(text)
    return str(d)


def make_pool(spec, seed: int, workdir: Path) -> tuple:
    """The cell's directories of documents and the warm-up's, made from
    the seed: directory k from the generator state (seed, k), the
    warm-up's from (seed, number of directories). A cell whose
    `warm_docs` is 0 warms up on its first directory, so the warm-up is
    the window's own work. One directory is written in this process,
    several by a pool of processes."""
    import multiprocessing as mp

    n = int(spec.cell["docs_per_invocation"])
    dirs = int(spec.cell["pool_dirs"])
    warm_docs = int(spec.cell["warm_docs"])
    jobs = [(str(spec.pkg), spec.config["generator"], spec.config, seed, k, k * n, n,
             str(workdir / "pool" / f"dir{k}")) for k in range(dirs)]
    if warm_docs:
        jobs.append((str(spec.pkg), spec.config["generator"], spec.config, seed, dirs, dirs * n,
                     warm_docs, str(workdir / "pool" / "warm")))
    if len(jobs) == 1:
        made = [Path(_write_dir(jobs[0]))]
    else:
        procs = min(len(jobs), max(1, (os.cpu_count() or 2) - 1))
        with mp.get_context("spawn").Pool(procs) as pool:
            made = [Path(d) for d in pool.map(_write_dir, jobs, chunksize=1)]
            pool.close()
            pool.join()
    # the documents reach the disk now, not while the window's journal
    # and result cache wait on their own writes
    os.sync()
    return (made[:-1], made[-1]) if warm_docs else (made, made[0])


def stage(what: str, since: float) -> float:
    """Log a stage's seconds on stderr; the time it ended."""
    now = time.perf_counter()
    print(f"portbench: {what}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def run(spec, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, workdir_root: Optional[str] = None) -> dict:
    """Set up, measure for `seconds`, check; the result line's dict. The
    program's state is freed before the check, whose reference runs on
    the host."""
    t_start = time.perf_counter() if t_start is None else t_start
    cache_env(spec.root)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-", dir=workdir_root))
    entry = None
    try:
        import torch

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
        at = stage("set-up: imports and the card", t_start)
        pool, warm_dir = make_pool(spec, seed, workdir)
        at = stage(f"set-up: {len(set(pool) | {warm_dir})} directories of documents", at)
        entry = spec.entry().Entry(spec, workdir, device)
        entry.prepare()
        at = stage("set-up: the entry's preparation", at)
        warm = entry.invoke("warm", warm_dir)
        at = stage(f"set-up: warm-up invocation (rc {warm['rc']})", at)
        entry.warm_workers(warm_dir)
        at = stage("set-up: every ingest worker warmed", at)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window = Window(spec, entry, pool, dev, trace)
        setup_s = time.perf_counter() - t_start
        window.measure(seconds)
        at = stage(f"window and its reading: {len(window.invocations)} invocations, "
                   f"{' '.join('%.3f' % inv['seconds'] for inv in window.invocations)} s", at)
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        found = {"this process": nojax.loaded_here()}
        for p, workers in entry.ingest_pools():
            answered = pools.each_worker(p, workers, nojax.loaded_in_worker, None)
            if len(answered) < workers:
                found["ingest workers"] = [f"{workers - len(answered)} of {workers} never answered"]
            for pid, names in answered.items():
                found[f"ingest worker {pid}"] = names
        done, entry = entry, None
        done.close()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        at = stage("no-JAX check and the ingest pool's end", at)
        checks = check_mod.check(spec, seed, window.invocations, done)
        stage("check against the reference", at)
        return window.result(setup_s, memory_peak, checks, found)
    finally:
        if entry is not None:
            entry.close()
        shutil.rmtree(workdir, ignore_errors=True)
