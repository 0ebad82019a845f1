"""The control's readings, from which a cell's limits are set (PERF.md,
"How correct is decided"), at the cell's own size. The benchmark's runs
never run this; the program's readings are its runs' own.

    python3 portbench/prove.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's first directory of documents as a run
makes it, draws the chunks a run would check, and compares with the
plain reference the control: the reference in the program's place with
each document cut to its first resources
(reference/sweep.control_outcome_of). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/prove.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import numpy as np

    from portbench.harness import check
    from portbench.harness import spec as spec_mod

    spec = spec_mod.load(root, args.workload)
    n = int(spec.cell["docs_per_invocation"])
    chunk = int(spec.traffic["chunk_size"])
    workdir = Path(tempfile.mkdtemp(prefix="portbench-prove-"))
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            d = workdir / f"seed{seed}"
            d.mkdir()
            texts = spec.generator().documents(spec.config, np.random.default_rng([seed, 0]), 0, n)
            for j, text in enumerate(texts):
                (d / f"doc{j:06d}.json").write_text(text)
            names = sorted(q.name for q in d.iterdir())
            units = [names[i: i + chunk] for i in range(0, len(names), chunk)]
            picked = check.sample_units(seed, list(range(len(units))), int(spec.cell["check_chunks"]))
            items = [(name, (d / name).read_text()) for u in picked for name in units[u]]
            t0 = time.perf_counter()
            want = check.reference_outcomes(spec.rules_dir(), items)
            t_ref = time.perf_counter() - t0
            got = check.reference_outcomes(spec.rules_dir(), items, control=True)

            def split(outcomes):
                out, at = [], 0
                for u in picked:
                    out.append(check.unit_answers(units[u], outcomes[at: at + len(units[u])]))
                    at += len(units[u])
                return out

            refs = split(want)
            line = {"workload": args.workload, "seed": seed, "docs": len(items),
                    "reference_s": t_ref, "control": check.compare(split(got), refs)}
            print(json.dumps(line), flush=True)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
