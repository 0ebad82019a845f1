"""The document axis over several devices: the port of the JAX
package's guard_tpu/parallel/mesh.py.

The JAX package shards every DocBatch array on its leading document
axis over a `jax.sharding.Mesh` and lets XLA run the walk SPMD, with
the per-rule summary counts reduced across the mesh (a psum, mesh.py:
338-355). Here a mesh is a plain *list* of torch devices, and
`ShardedBatchEvaluator` holds one `DeviceBatchEvaluator` (parallel/
device.py) per entry:

  * `dispatch` cuts a bucket's D documents into contiguous slices, one
    per device, copies each slice's columns to its device and enqueues
    the walk (and K3 behind it) on that device's stream; it returns
    once every device has its work;
  * `collect` waits for each device and concatenates the statuses,
    unsure bits and the six rim blocks in document order;
  * `with_summary` runs kernel K7 on each device over its slice and
    sums the (3, R) counts on the host, the counterpart of the psum.

The JAX package pads D to a multiple of the mesh size
(`pad_to_multiple`, mesh.py:74); the port does not pad (a slice is as
long as it is), so the `docs_padded` counter has no counterpart here.

`visible_devices` is what a default mesh spans: every card for an
unindexed CUDA request, one card for an indexed one, the CPU for the
CPU. Tests on the CPU patch it to `[cpu] * k`, the counterpart of the
JAX tests' `--xla_force_host_platform_device_count=8`. A device may
appear in a mesh more than once; each entry then has its own stream.

A mesh spans one process. Several processes, the JAX package's
`jax.distributed` runs of this module (the dcn axis of
`hierarchical_mesh`), are `parallel/distributed.py`: each rank takes a
contiguous range of the documents and a mesh of its own cards, and the
summary counts are all-reduced over a `torch.distributed` group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.encoder import DocBatch
from ..ops.ir import CompiledRules
from .device import (
    DeviceBatchEvaluator,
    build_walk,
    evaluate_bucketed as _evaluate_bucketed,
    resolve_device,
)

def visible_devices(device=None) -> List[torch.device]:
    """The devices a default mesh spans for a `device` request: every
    CUDA card for an unindexed `cuda` (or no request), that card alone
    for `cuda:k`, and `[device]` for anything else (the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


#: the flat document-axis mesh over the visible devices (the JAX name)
default_mesh = visible_devices


def hierarchical_mesh(devices: Optional[Sequence] = None,
                      n_slices: int = 1) -> List[torch.device]:
    """The (dcn, ici) layout of the JAX package's hierarchical_mesh on
    one host: the document axis splits first across `n_slices` slices,
    then across each slice's devices. Read slice-major, as the JAX
    mesh's devices array is, that is the order of `devices`; the
    device count must split into the slices."""
    devices = list(devices) if devices is not None else visible_devices()
    if len(devices) % n_slices:
        raise ValueError(f"{len(devices)} devices do not split into {n_slices} slices")
    return devices


def slice_bounds(n_docs: int, n_devices: int) -> List[Tuple[int, int]]:
    """Contiguous (lo, hi) document slices, one per device, the first
    `n_docs % n_devices` one document longer; a device past the
    documents gets an empty slice."""
    base, rem = divmod(n_docs, max(1, n_devices))
    bounds, lo = [], 0
    for i in range(n_devices):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def take_docs(batch: DocBatch, lo: int, hi: int) -> DocBatch:
    """Contiguous document-range slice of an encoded batch (numpy views,
    no copies). The derived per-node columns are passed through so
    __post_init__ skips the edge re-scatter."""
    if lo == 0 and hi == batch.n_docs:
        return batch
    sl = slice(lo, hi)
    return DocBatch(
        node_kind=batch.node_kind[sl],
        node_parent=batch.node_parent[sl],
        scalar_id=batch.scalar_id[sl],
        num_hi=batch.num_hi[sl],
        num_lo=batch.num_lo[sl],
        child_count=batch.child_count[sl],
        edge_parent=batch.edge_parent[sl],
        edge_child=batch.edge_child[sl],
        edge_key_id=batch.edge_key_id[sl],
        edge_index=batch.edge_index[sl],
        edge_valid=batch.edge_valid[sl],
        n_docs=hi - lo,
        n_nodes=batch.n_nodes,
        n_edges=batch.n_edges,
        node_key_id=batch.node_key_id[sl],
        node_index=batch.node_index[sl],
        node_parent_kind=batch.node_parent_kind[sl],
        num_exotic=batch.num_exotic[sl],
        fn_origin=batch.fn_origin[sl] if batch.fn_origin is not None else None,
    )


class ShardedBatchEvaluator:
    """The (docs x rules) status evaluator over a list of devices, with
    the protocol of DeviceBatchEvaluator: `dispatch` / `collect`
    (statuses, unsure bits and, with a `rim_spec`, the six rim blocks;
    `rim_blocks` and `ship_statuses` narrow what is copied back, as
    there), `__call__`, `evaluate_bucketed`, `with_summary` and
    `rim_of`. `devices` defaults to the mesh of `device`
    (visible_devices)."""

    def __init__(self, compiled: CompiledRules, devices: Optional[Sequence] = None,
                 rim_spec=None, rim_blocks=None, ship_statuses: bool = True,
                 device=None):
        self.compiled = compiled
        self.devices = list(devices) if devices is not None else visible_devices(device)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        fn = build_walk(compiled)
        self.shards = [
            DeviceBatchEvaluator(compiled, dev, rim_spec=rim_spec, rim_blocks=rim_blocks,
                                 ship_statuses=ship_statuses, fn=fn)
            for dev in self.devices
        ]
        self.device = self.shards[0].device
        self.rim_spec = rim_spec
        self.ship_statuses = self.shards[0].ship_statuses
        self._with_unsure = compiled.needs_unsure
        self.last_unsure: Optional[np.ndarray] = None

    def _slices(self, batch: DocBatch):
        """(evaluator, slice batch) for every device with documents;
        a batch with none goes whole to the first device."""
        parts = [
            (ev, take_docs(batch, lo, hi))
            for ev, (lo, hi) in zip(self.shards, slice_bounds(batch.n_docs, len(self.shards)))
            if hi > lo
        ]
        return parts or [(self.shards[0], batch)]

    def dispatch(self, batch: DocBatch):
        """Enqueue one bucket on every device of the mesh without
        waiting (each device's slice counts one dispatch): returns
        ([(evaluator, handle)], d, None)."""
        return [(ev, ev.dispatch(sub)) for ev, sub in self._slices(batch)], batch.n_docs, None

    def collect(self, handle):
        """Wait for every device of a dispatch and concatenate its
        results in document order: (statuses, unsure), plus the rim
        blocks with a rim_spec; a block or matrix that was not copied
        back stays None."""
        parts, _d, _ = handle
        got = [ev.collect(h) for ev, h in parts]
        if len(got) == 1:
            return got[0]

        def cat(k):
            pieces = [g[k] for g in got]
            return None if pieces[0] is None else np.concatenate(pieces, axis=0)

        out = (cat(0), cat(1))
        if self.rim_spec is None:
            return out
        blocks = tuple(
            None if got[0][2][b] is None
            else np.concatenate([g[2][b] for g in got], axis=0)
            for b in range(len(got[0][2]))
        )
        return out + (blocks,)

    def rim_of(self, statuses: np.ndarray, unsure: Optional[np.ndarray]) -> tuple:
        return self.shards[0].rim_of(statuses, unsure)

    def __call__(self, batch: DocBatch) -> np.ndarray:
        st, un = self.collect(self.dispatch(batch))[:2]
        self.last_unsure = un
        return st

    def evaluate_bucketed(self, batch: DocBatch):
        if len(self.shards) == 1:
            # a mesh of one device is that device's evaluator
            return self.shards[0].evaluate_bucketed(batch)
        return _evaluate_bucketed(self, len(self.compiled.rules), batch)

    def with_summary(self, batch: DocBatch) -> Tuple[np.ndarray, np.ndarray]:
        """(statuses (d, R) int8, counts (3, R) int32): each device runs
        the walk and K7 over its slice, and the per-device counts are
        summed, as the JAX package's psum across its mesh."""
        if len(self.shards) == 1:
            return self.shards[0].with_summary(batch)
        pending = [(ev, ev.summary_enqueue(sub)) for ev, sub in self._slices(batch)]
        got = [ev.summary_collect(h) for ev, h in pending]
        statuses = np.concatenate([st for st, _c in got], axis=0)
        counts = got[0][1].astype(np.int64)
        for _st, c in got[1:]:
            counts = counts + c
        return statuses, counts.astype(np.int32)

