"""The process pool of oracle reruns, as in the JAX package's backend
(guard_tpu/ops/backend.py `_oracle_pool_init`, `_oracle_job`,
`_run_oracle_jobs`).

A report run reruns every failing document on the CPU evaluator; those
reruns are independent pure-Python work, so once there are enough of
them they fan out over a spawn pool. The workers are spawned, not
forked (a fork would inherit the parent's CUDA context), and this
module imports only the pure-Python core: a worker never imports torch,
JAX or the JAX package (`worker_modules` reports what one holds).
"""

from __future__ import annotations

import sys

from ..commands.report import rule_statuses_from_root, simplified_report_from_root
from ..core.errors import GuardError
from ..core.evaluator import eval_rules_file
from ..core.scopes import RootScope

# reruns below this count stay inline (spawn and import cost dominates)
POOL_MIN_JOBS = 48
# the most workers one pool starts
POOL_MAX_WORKERS = 16

# a worker's rules files, parsed once by the pool's initializer
_WORKER_RULES: dict = {}


def _oracle_pool_init(rule_texts) -> None:
    global _WORKER_RULES
    from ..core.parser import parse_rules_file

    _WORKER_RULES = {}
    for key, name, text in rule_texts:
        _WORKER_RULES[key] = parse_rules_file(text, name)


def _oracle_job(args):
    """One oracle rerun in a worker process: returns
    (doc_key, status_value, report, {rule: status_value}, error)."""
    rules_key, doc_key, doc_name, doc_content = args
    rf = _WORKER_RULES[rules_key]
    try:
        from ..core.loader import load_document

        doc = load_document(doc_content, doc_name)
        scope = RootScope(rf, doc)
        status = eval_rules_file(rf, scope, doc_name)
    except GuardError as e:
        return (doc_key, None, None, None, str(e))
    root = scope.reset_recorder().extract()
    report = simplified_report_from_root(root, doc_name)
    statuses = {n: s.value for n, s in rule_statuses_from_root(root).items()}
    return (doc_key, status.value, report, statuses, None)


def run_oracle_jobs(rules_key, rule_file, jobs, workers: int) -> dict:
    """Fan the oracle reruns over a spawn pool of `workers` processes;
    {doc_key: job result}."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = {}
    with ctx.Pool(
        processes=workers,
        initializer=_oracle_pool_init,
        initargs=([(rules_key, rule_file.name, rule_file.content)],),
    ) as pool:
        for res in pool.imap_unordered(_oracle_job, jobs, chunksize=8):
            results[res[0]] = res
    return results


def worker_modules(_arg=None) -> list:
    """The modules of torch, JAX and the JAX package this process holds
    (run in a pool worker, it must return [])."""
    return sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("torch", "jax", "jaxlib", "guard_tpu")
    )
