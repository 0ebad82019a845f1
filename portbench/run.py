"""The benchmark of guard_tpu_torch, the PyTorch and CUDA port, on NVIDIA
cards: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on stdout, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, and last `check`, each number compared with its limit (also
the last lines on stderr). Without a card, with fewer cards than the
cell asks for, without the port beside it, or when the run loaded JAX
or the JAX package, it prints no result and exits non-zero.

Worker processes re-import this file, so it imports nothing heavy at
its top.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench.harness import bench, nojax
    from portbench.harness import spec as spec_mod

    try:
        spec = spec_mod.load(root, args.workload)
    except (KeyError, OSError, ValueError) as e:
        return fail(f"cannot load the cell: {e}", 2)
    # the program reads some of its cache directories when imported
    bench.cache_env(root)
    try:
        import guard_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the port guard_tpu_torch cannot be imported: {e}", 2)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark runs on the card only", 3)
    if torch.cuda.device_count() < spec.chips:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {spec.chips}", 3)
    result = bench.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = result.pop("_found")
    found["this process"] = nojax.loaded_here()
    loaded = {where: names for where, names in found.items() if names}
    if loaded:
        for where, names in loaded.items():
            print(f"portbench: {where} loaded {', '.join(names)}", file=sys.stderr)
        return fail("the run loaded JAX or the JAX package; no result", 4)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
