"""The (docs x packs) mesh of `--mesh-shape`, as far as one card reaches.

The port's copy of the shape grammar of guard_tpu/parallel/mesh2d.py.
Shape semantics — `--mesh-shape`, resolved by `resolve_mesh_shape`:

  * ``RxC`` — R DOC shards x C pack COLUMNS. A column is a group of
    devices; a shape that wants more columns than there are cards logs
    the JAX package's warning and falls back to the unsharded path.
  * ``auto`` / no flag — (2, 1) when >= 2 devices are visible, else
    off.
  * ``off`` / ``none`` / ``0`` / ``1`` / ``1x1`` — unsharded.

The packed dispatch (ops/backend.dispatch_packs) resolves the shape
where the JAX package does, so a malformed value raises the same
ValueError and a too-wide one logs the same warning, and then runs
unsharded for every shape: on one card, doc shards dispatched in turn
only add walks and launches. The sharded half (the doc-shard loop, the
rim-only collect, the per-shard gauges, MeshSweepEvaluator's column
sub-meshes, ShardPrefetcher) waits for a port that spans several cards.
"""

from __future__ import annotations

import logging
import re
from typing import Optional, Tuple

log = logging.getLogger("guard_tpu_torch.mesh2d")

_SHAPE_RE = re.compile(r"(\d+)\s*x\s*(\d+)")


def device_count(device=None) -> int:
    """The devices a mesh may span: the CUDA cards for a CUDA device
    (`torch.cuda.device_count()`), one for the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return 1


def resolve_mesh_shape(raw: Optional[str], n_devices: int) -> Optional[Tuple[int, int]]:
    """(doc_shards, pack_columns) from the `--mesh-shape` value `raw`
    (None = auto), or None for the unsharded path. A malformed value
    raises the JAX package's ValueError."""
    raw = ("" if raw is None else raw).strip().lower()
    if raw in ("off", "none", "0", "1", "1x1"):
        return None
    if raw in ("", "auto"):
        return (2, 1) if n_devices >= 2 else None
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
    if c > n_devices:
        log.warning(
            "GUARD_TPU_MESH=%s wants %d pack columns but only %d "
            "device(s) are visible; falling back to the unsharded path",
            raw, c, n_devices,
        )
        return None
    return r, c
