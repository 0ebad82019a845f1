"""The 2-D (docs x packs) mesh of `--mesh-shape`: the port of the JAX
package's guard_tpu/parallel/mesh2d.py.

Shape semantics — `--mesh-shape`, resolved by `resolve_mesh_shape`:

  * ``RxC`` — R DOC shards x C pack COLUMNS. The visible cards
    partition into C contiguous groups (`column_mesh`); each planned
    pack is assigned to one column (`assign_columns`, the greedy
    rule-count balance of rules.partition_packs) and its documents are
    cut over that column's cards (mesh.ShardedBatchEvaluator). A shape
    that wants more columns than there are cards logs the JAX
    package's warning and falls back to the unsharded path.
  * ``auto`` / no flag — (2, 1) when >= 2 cards are visible, else off.
  * ``off`` / ``none`` / ``0`` / ``1`` / ``1x1`` — unsharded.

Doc shards are CONTIGUOUS document ranges (`doc_shard_bounds`), never
an interleave, and the shard boundary is the degradation boundary: a
dispatch or collect fault on one (doc shard, pack, bucket) reruns that
bucket of that shard per file on the pack's cards
(ops/backend.collect_packs), and every other shard's results stand. `GUARD_TPU_MESH_MIN_DOCS` (default 32) floors the
documents a shard carries, so a small batch stays one shard.

The one-card rule: with one visible device every shape runs unsharded
(ops/backend.dispatch_packs), so a one-card run issues the same walks
and launches whatever the flag says; the JAX package cuts doc shards on
one device too. `RIM_PROFILES` name the rim blocks each consumer reads:
on the mesh only those leave the cards (`ship_statuses=False`, the
statuses stay there).
"""

from __future__ import annotations

import logging
import os
import re
import threading as _threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.encoder import DocBatch
from ..utils.telemetry import REGISTRY as _TELEMETRY
from . import mesh
from .device import _EFFICIENCY_RESET_HOOKS, EFFICIENCY_COUNTERS
from .mesh import ShardedBatchEvaluator, take_docs

log = logging.getLogger("guard_tpu_torch.mesh2d")

_SHAPE_RE = re.compile(r"(\d+)\s*x\s*(\d+)")

# the rim blocks each consumer reads (ShardedBatchEvaluator rim_blocks):
# the report path (validate) reads blocks 0-4, the sweep's tally only
# any_unsure (4) and name_last (5)
RIM_PROFILES = {
    "validate": (0, 1, 2, 3, 4),
    "sweep": (4, 5),
}


def device_count(device=None) -> int:
    """The devices a mesh may span for a `device` request
    (mesh.visible_devices)."""
    return len(mesh.visible_devices(device))


def parse_mesh_shape(raw: Optional[str]):
    """The grammar of a `--mesh-shape` value `raw` (None = auto): None
    for the unsharded path, "auto", or (R, C). A malformed value raises
    the JAX package's ValueError."""
    raw = ("" if raw is None else raw).strip().lower()
    if raw in ("off", "none", "0", "1", "1x1"):
        return None
    if raw in ("", "auto"):
        return "auto"
    m = _SHAPE_RE.fullmatch(raw)
    if m is None:
        raise ValueError(
            f"GUARD_TPU_MESH={raw!r}: expected RxC (e.g. 2x4), "
            "'auto', or 'off'"
        )
    r, c = int(m.group(1)), int(m.group(2))
    if r < 1 or c < 1:
        raise ValueError(f"GUARD_TPU_MESH={raw!r}: axes must be >= 1")
    if (r, c) == (1, 1):
        return None
    return r, c


def resolve_mesh_shape(raw: Optional[str], n_devices: int) -> Optional[Tuple[int, int]]:
    """(doc_shards, pack_columns) from the `--mesh-shape` value `raw`
    (None = auto) for `n_devices` visible devices, or None for the
    unsharded path; a shape with more columns than devices logs the JAX
    package's warning and is None."""
    shape = parse_mesh_shape(raw)
    if shape is None:
        return None
    if shape == "auto":
        return (2, 1) if n_devices >= 2 else None
    r, c = shape
    if c > n_devices:
        log.warning(
            "GUARD_TPU_MESH=%s wants %d pack columns but only %d "
            "device(s) are visible; falling back to the unsharded path",
            ("" if raw is None else raw).strip().lower(), c, n_devices,
        )
        return None
    return r, c


def min_shard_docs() -> int:
    try:
        return int(os.environ.get("GUARD_TPU_MESH_MIN_DOCS", "32") or 32)
    except ValueError:
        return 32


def doc_shard_bounds(n_docs: int, r: int) -> List[Tuple[int, int]]:
    """Contiguous (lo, hi) doc ranges for <= r shards, floored so every
    shard carries at least GUARD_TPU_MESH_MIN_DOCS documents (a small
    batch collapses to one shard)."""
    floor = max(1, min_shard_docs())
    s = max(1, min(r, n_docs // floor))
    base, rem = divmod(n_docs, s)
    bounds, lo = [], 0
    for i in range(s):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def shard_groups(groups, oversize, lo: int, hi: int):
    """The part of a bucketed encode in the documents [lo, hi): per
    bucket (sub-batch, document indices) as `groups`, the bucket's rows
    of the shard cut out of its batch, and the `oversize` documents in
    the range. The counterpart of the JAX package's take_docs followed
    by split_batch_by_size: the port's encode is bucketed already."""
    out = []
    for sub, idx in groups:
        idx = np.asarray(idx)
        sel = np.nonzero((idx >= lo) & (idx < hi))[0]
        if len(sel) == 0:
            continue
        a, b = int(sel[0]), int(sel[-1]) + 1
        if b - a == len(sel):
            out.append((take_docs(sub, a, b), idx[a:b]))
        else:
            from ..ops.encoder import take_doc_subset

            out.append((take_doc_subset(sub, sel), idx[sel]))
    over = np.asarray([int(i) for i in oversize if lo <= int(i) < hi], dtype=np.int64)
    return out, over


def column_mesh(shape: Tuple[int, int], column: int,
                devices: Optional[Sequence] = None) -> list:
    """The devices of pack column `column` of `shape`: C=1 spans every
    device (the default mesh); C>1 partitions the devices contiguously,
    laying a column out as the hierarchical (dcn, ici) mesh when it is
    big and even enough to split into two slices."""
    devices = list(devices) if devices is not None else mesh.visible_devices()
    _r, c = shape
    if c <= 1:
        return list(devices)
    groups = np.array_split(np.arange(len(devices)), c)
    col_devices = [devices[i] for i in groups[column]]
    m = len(col_devices)
    if m >= 4 and m % 2 == 0:
        return mesh.hierarchical_mesh(col_devices, n_slices=2)
    return col_devices


def assign_columns(loads: Sequence[int], n_columns: int) -> List[int]:
    """Greedy min-load column per item (largest first) — the
    rules.partition_packs balance discipline, but returning a per-item
    column index so pack order is preserved."""
    n_columns = max(1, n_columns)
    col_load = [0] * n_columns
    out = [0] * len(loads)
    for i in sorted(range(len(loads)), key=lambda i: -loads[i]):
        g = col_load.index(min(col_load))
        out[i] = g
        col_load[g] += max(1, loads[i])
    return out


# -- per-doc-shard efficiency attribution ------------------------------
# cumulative per-shard h2d/d2h bytes and doc fill, attributed by the
# EFFICIENCY_COUNTERS deltas around each dispatch and collect and shown
# as the `efficiency.shard_{s}.h2d / d2h / doc_fill` gauges. The delta
# window is not held under the lock across the (blocking) device call,
# so concurrent mesh evaluations can misattribute bytes between shards;
# these are gauges, and the sweep, the mesh's main consumer, is one
# thread. The port pads no document, so a shard's doc fill is 1.0.
_SHARD_LOCK = _threading.Lock()
_SHARD_TOTALS: dict = {}


def _reset_shard_totals() -> None:
    _SHARD_TOTALS.clear()


_EFFICIENCY_RESET_HOOKS.append(_reset_shard_totals)


def _shard_totals(shard: int) -> dict:
    return _SHARD_TOTALS.setdefault(int(shard), {"h2d": 0, "d2h": 0})


class MeshSweepEvaluator:
    """One pack's evaluator on the 2-D mesh: a ShardedBatchEvaluator on
    this pack's COLUMN of cards, dispatched once per (doc shard,
    bucket) with per-shard efficiency attribution. `rim_blocks` /
    `ship_statuses` narrow the collect to the consumer's rim profile
    (RIM_PROFILES): K3 already ran behind each walk, so only the blocks
    the profile names leave the cards."""

    def __init__(self, compiled, rim_spec=None,
                 shape: Optional[Tuple[int, int]] = None, column: int = 0,
                 rim_blocks=None, ship_statuses: bool = True,
                 devices: Optional[Sequence] = None):
        devs = (
            column_mesh(shape, int(column), devices) if shape is not None
            else (list(devices) if devices is not None else None)
        )
        self._ev = ShardedBatchEvaluator(
            compiled, devs, rim_spec=rim_spec,
            rim_blocks=rim_blocks, ship_statuses=ship_statuses,
        )
        self.devices = self._ev.devices

    def dispatch(self, sub: DocBatch, shard: int = 0):
        h2d0 = EFFICIENCY_COUNTERS["host_to_device_bytes"]
        handle = self._ev.dispatch(sub)
        with _SHARD_LOCK:
            tot = _shard_totals(shard)
            tot["h2d"] += EFFICIENCY_COUNTERS["host_to_device_bytes"] - h2d0
            _TELEMETRY.set_gauge(f"efficiency.shard_{shard}.doc_fill", 1.0)
            _TELEMETRY.set_gauge(f"efficiency.shard_{shard}.h2d", tot["h2d"])
        return shard, handle

    def collect(self, handle):
        shard, inner = handle
        d2h0 = EFFICIENCY_COUNTERS["device_to_host_bytes"]
        out = self._ev.collect(inner)
        with _SHARD_LOCK:
            tot = _shard_totals(shard)
            tot["d2h"] += EFFICIENCY_COUNTERS["device_to_host_bytes"] - d2h0
            _TELEMETRY.set_gauge(f"efficiency.shard_{shard}.d2h", tot["d2h"])
        return out

    def rim_of(self, statuses, unsure):
        return self._ev.rim_of(statuses, unsure)
