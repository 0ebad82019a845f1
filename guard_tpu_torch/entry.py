"""Entry points of the port: a forward check and a dry run.

The counterparts of the JAX package's `__graft_entry__.py`:

  * `entry(device)` returns the flagship walk (rule set x document
    batch -> tri-state statuses) with example tensors on the device;
  * `dryrun(device)` runs one full evaluation of the
    flagship plus a host-fallback rule: the bucketed evaluation over two
    node buckets on the visible cards, parity with a CPU evaluation of
    the same batch, and the per-rule summary counts of kernel K7
    (`with_summary`);
  * `dryrun_multichip(n, devices)` runs the same evaluation over a mesh
    of n devices (parallel/mesh.py; the hierarchical layout when n is
    even and at least 4), held equal to one device's, with the K7
    counts summed across the mesh.

They run on the card unless the caller asks for another device.

    python -m guard_tpu_torch.entry [--device cpu] [--multichip N]
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np

from .core.parser import parse_rules_file
from .core.values import from_plain
from .ops.encoder import DocBatch, encode_batch
from .ops.ir import FAIL, CompiledRules, compile_rules_file
from .ops.kernels import arrays_from_numpy
from .parallel.device import DeviceBatchEvaluator, build_walk, resolve_device
from .parallel import mesh as _mesh
from .parallel.mesh import ShardedBatchEvaluator, hierarchical_mesh
from .workloads import FLAGSHIP_RULES, HOST_ORACLE_RULES, example_docs


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {msg}")


def _compiled_batch(rules_text: str, docs) -> Tuple[CompiledRules, DocBatch]:
    """Parse and lower `rules_text` against one batch of `docs`, padded
    to its largest document."""
    rules = parse_rules_file(rules_text, "flagship.guard")
    batch, interner = encode_batch([from_plain(d) for d in docs])
    compiled = compile_rules_file(rules, interner)
    _check(compiled.rules, "flagship rules must be lowerable")
    return compiled, batch


def entry(device=None):
    """(forward, (arrays, lits)): the flagship walk over 8 example
    documents, its input tensors on `device` (CUDA unless given).
    forward(arrays, lits) -> (statuses (8, R) int8, unsure (8, R) bool)."""
    dev = resolve_device(device)
    compiled, batch = _compiled_batch(FLAGSHIP_RULES, example_docs(8))
    arrays, lits = arrays_from_numpy(
        compiled.device_arrays(batch), compiled.lit_values(), dev
    )
    return build_walk(compiled), (arrays, lits)


def dryrun(device=None):
    """One full evaluation step on one device: the flagship rules plus a
    `now()` rule that stays on the host, over 2 example documents in two
    node buckets. The bucketed statuses must equal a CPU evaluation of
    the same batch and include a FAIL; the K7 counts must cover every
    (document, rule) pair. Prints one `dryrun OK` line and returns
    (statuses (2, R) int8, counts (3, R) int32)."""
    dev = resolve_device(device)
    compiled, batch = _compiled_batch(
        HOST_ORACLE_RULES, example_docs(2, two_buckets=True)
    )
    # the now() rule stays on the host: the mixed device/host split
    _check(any(r.rule_name == "freshness_guard" for r in compiled.host_rules),
           "expected a host-fallback rule in the mix")
    n_rules = len(compiled.rules)
    d = batch.n_docs

    evaluator = ShardedBatchEvaluator(compiled, device=dev)
    statuses, _unsure, host_docs, _rim = evaluator.evaluate_bucketed(batch)
    _check(statuses.shape == (d, n_rules), f"statuses {statuses.shape}")
    _check(not host_docs, "no document may exceed the device ceiling")
    n_buckets = len({int((batch.node_kind[i] >= 0).sum()) > 64 for i in range(d)})
    _check(n_buckets == 2, "the batch must span two node buckets")

    cpu = DeviceBatchEvaluator(compiled, "cpu")
    cpu_statuses = cpu.evaluate_bucketed(batch)[0]
    _check(np.array_equal(statuses, cpu_statuses),
           f"{dev} statuses diverge from the CPU's")
    _check(bool((statuses == FAIL).any()), "the mix must include FAILs")

    summary_statuses, counts = evaluator.with_summary(batch)
    _check(np.array_equal(summary_statuses, statuses),
           "with_summary statuses diverge from the bucketed ones")
    _check(int(counts.sum()) == d * n_rules,
           f"counts sum to {int(counts.sum())}, want {d * n_rules}")
    n_dev = len(evaluator.devices)
    print(
        f"dryrun OK: {n_dev} {dev.type} device{'s' if n_dev > 1 else ''}, "
        f"batch {d} over {n_buckets} buckets, "
        f"rules {n_rules} device + {len(compiled.host_rules)} host-fallback, "
        f"counts P/F/S = {counts.sum(axis=1).tolist()}; CPU bit-parity OK"
    )
    return summary_statuses, counts


def dryrun_multichip(n: int, devices=None, device=None):
    """The flagship plus a host-fallback rule over 2n example documents
    in two node buckets, cut across a mesh of `n` devices: the first n
    of `visible_devices(device)` (CUDA unless given; raises when fewer
    are visible), or `devices`, which may name one device several
    times. The mesh's statuses must equal one device's, and K7's counts,
    summed across the mesh, must cover every (document, rule) pair.
    Prints one `dryrun_multichip OK` line and returns (statuses (2n, R)
    int8, counts (3, R) int32)."""
    if devices is None:
        visible = _mesh.visible_devices(device)
        if len(visible) < n:
            raise RuntimeError(f"need {n} devices, have {len(visible)}")
        devices = visible[:n]
    devices = list(devices)
    _check(len(devices) == n, f"{len(devices)} devices given for a mesh of {n}")
    compiled, batch = _compiled_batch(
        HOST_ORACLE_RULES, example_docs(2 * n, two_buckets=True)
    )
    _check(any(r.rule_name == "freshness_guard" for r in compiled.host_rules),
           "expected a host-fallback rule in the mix")
    # the hierarchical (dcn, ici) order when the device count splits,
    # the flat one otherwise: the same evaluator either way
    if n % 2 == 0 and n >= 4:
        mesh, axes = hierarchical_mesh(devices, n_slices=2), ("dcn", "ici")
    else:
        mesh, axes = devices, ("docs",)
    evaluator = ShardedBatchEvaluator(compiled, mesh)
    n_rules = len(compiled.rules)
    d = batch.n_docs

    statuses, _unsure, host_docs, _rim = evaluator.evaluate_bucketed(batch)
    _check(statuses.shape == (d, n_rules), f"statuses {statuses.shape}")
    _check(not host_docs, "no document may exceed the device ceiling")
    n_buckets = len({int((batch.node_kind[i] >= 0).sum()) > 64 for i in range(d)})
    _check(n_buckets == 2, "the batch must span two node buckets")
    single = DeviceBatchEvaluator(compiled, evaluator.device).evaluate_bucketed(batch)[0]
    _check(np.array_equal(statuses, single),
           "mesh statuses diverge from single-device statuses")
    _check(bool((statuses == FAIL).any()), "the mix must include FAILs")

    summary_statuses, counts = evaluator.with_summary(batch)
    _check(np.array_equal(summary_statuses, statuses),
           "with_summary statuses diverge from the bucketed ones")
    _check(int(counts.sum()) == d * n_rules,
           f"counts sum to {int(counts.sum())}, want {d * n_rules}")
    print(
        f"dryrun_multichip OK: {n} {evaluator.device.type} devices, "
        f"mesh axes {axes}, batch {d} over 2 buckets, "
        f"rules {n_rules} device + {len(compiled.host_rules)} host-fallback, "
        f"counts P/F/S = {counts.sum(axis=1).tolist()}; "
        f"single-device bit-parity OK"
    )
    return summary_statuses, counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m guard_tpu_torch.entry",
        description="Forward check and dry run of the port on one device.",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    parser.add_argument("--multichip", type=int, default=None, metavar="N",
                        help="also run dryrun_multichip over the first N "
                        "visible devices")
    args = parser.parse_args(argv)
    forward, example = entry(args.device)
    statuses, _unsure = forward(*example)
    print("entry OK:", statuses.cpu().numpy().tolist())
    dryrun(args.device)
    if args.multichip:
        dryrun_multichip(args.multichip, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
