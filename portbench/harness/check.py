"""How `correct` is decided.

The window's own invocations are judged. Every invocation must have
ended as a sweep that answers does (exit 0 or 19, every document
counted, none quarantined). Then chunks drawn from the seed among the
window's invocations are judged document by document against the plain
reference (portbench/reference), which works from the rule texts and
the document texts alone and runs on the host once the program's state
is freed, in a pool of processes:

  * doc_mismatches: documents whose failing rules differ from the
    reference's (a document that does not fail lists none);
  * count_mismatches: the sum over PASS, FAIL and SKIP of the gap
    between the chunk's counts and the reference's;
  * error_mismatches: the gap between the chunk's errors and the
    reference's (rules files on which its evaluator raises);
  * bad_invocations: invocations that did not end as above.

Each is exact, so each limit is 0.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
from pathlib import Path
from typing import Dict, List

LIMITS = {"doc_mismatches": 0, "count_mismatches": 0, "error_mismatches": 0,
          "bad_invocations": 0}


def sample_units(seed: int, units: list, n: int) -> list:
    import numpy as np

    if len(units) <= n:
        return list(units)
    rng = np.random.default_rng([seed, 1])
    return [units[i] for i in sorted(rng.choice(len(units), size=n, replace=False))]


def reference_outcomes(rules_dir: Path, items: List[tuple], processes: int = 0,
                       control: bool = False) -> list:
    """The reference's outcome of each (name, text), over a spawn pool;
    with `control`, the control's (reference/sweep.py)."""
    from portbench.reference import sweep as ref

    fn = ref.control_outcome_of if control else ref.outcome_of
    if not items:
        return []
    if processes <= 0:
        processes = max(1, min((os.cpu_count() or 2) - 1, len(items) // 32 + 1))
    if processes == 1:
        ref.init_worker(str(rules_dir))
        return [fn(item) for item in items]
    ctx = mp.get_context("spawn")
    with ctx.Pool(processes, initializer=ref.init_worker, initargs=(str(rules_dir),)) as pool:
        out = pool.map(fn, items, chunksize=max(1, len(items) // (4 * processes)))
        pool.close()
        pool.join()
    return out


def unit_answers(docs: List[str], outcomes: list) -> dict:
    """What a sweep prints for a chunk whose documents have these
    outcomes: its counts, its failing documents and its errors."""
    counts = {"pass": 0, "fail": 0, "skip": 0}
    failed = {}
    for name, o in zip(docs, outcomes):
        counts[o["status"]] += 1
        if o["fails"]:
            failed[name] = o["fails"]
    return {"docs": docs, "counts": counts, "failed": failed,
            "errors": sum(len(o["raised"]) for o in outcomes)}


def compare(units: List[dict], refs: List[dict]) -> Dict[str, int]:
    """The gaps between the program's answers and the reference's, unit
    by unit (each as `unit_answers` gives them)."""
    doc_mm = count_mm = err_mm = 0
    for got, want in zip(units, refs):
        for name in want["docs"]:
            if got["failed"].get(name, []) != want["failed"].get(name, []):
                doc_mm += 1
        count_mm += sum(abs(got["counts"].get(k, 0) - want["counts"][k]) for k in want["counts"])
        err_mm += abs(int(got["errors"]) - int(want["errors"]))
    return {"doc_mismatches": doc_mm, "count_mismatches": count_mm,
            "error_mismatches": err_mm}


def check(spec, seed: int, invocations: List[dict], entry) -> dict:
    bad = sum(1 for inv in invocations if entry.problems(inv))
    for inv in invocations:
        for p in entry.problems(inv):
            print(f"portbench: invocation {inv['label']}: {p}", file=sys.stderr)
    units = [(inv, u) for inv in invocations for u in entry.chunks(inv)]
    picked = sample_units(seed, units, int(spec.cell["check_chunks"]))
    items, spans = [], []
    for inv, u in picked:
        at = len(items)
        items += [(name, (Path(inv["docdir"]) / name).read_text()) for name in u["docs"]]
        spans.append((at, len(items)))
    outcomes = reference_outcomes(spec.rules_dir(), items)
    refs = [unit_answers(u["docs"], outcomes[a:b]) for (_inv, u), (a, b) in zip(picked, spans)]
    numbers = compare([u for _inv, u in picked], refs)
    numbers["bad_invocations"] = bad
    print(f"portbench: checked {len(items)} documents in {len(picked)} chunks of "
          f"{len(invocations)} invocations", file=sys.stderr)
    if not picked:
        numbers["bad_invocations"] = max(bad, 1)
    judged = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return {"correct": all(v <= LIMITS[k] for k, v in numbers.items()), "numbers": judged}
