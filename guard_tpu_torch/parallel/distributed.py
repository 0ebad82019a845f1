"""Several processes over one corpus: the port of running the JAX
package's guard_tpu/parallel/mesh.py under `jax.distributed`.

The JAX package forms one global (dcn, ici) mesh across processes
(`hierarchical_mesh`, mesh.py:55-71): the document axis splits first
across processes (dcn), then across each process's devices (ici), and
the only traffic between processes is the psum of the per-rule summary
counts (`_shared_evaluator_fns.summarize`, mesh.py:338-355). Here each
process is a rank of a `torch.distributed` process group:

  * `initialize` joins the group over TCP (`init_process_group` with a
    `tcp://` address, the world size and this rank, gloo by default:
    the only traffic is 3 x R integers, and one card cannot host two
    NCCL ranks); `shutdown` leaves it;
  * `process_bounds` is this rank's contiguous document range, the dcn
    axis; `local_devices` its cards, the ici axis, over which a
    `parallel/mesh.ShardedBatchEvaluator` cuts each bucket;
  * `DistributedEvaluator.with_summary` runs the walk and kernel K7 on
    the rank's cards, sums the counts over its buckets and cards, and
    all-reduces them (SUM) over the group, the counterpart of the psum.

Each rank encodes only its own documents: a document's statuses do not
depend on what else was encoded with it, and the port has no global
array to assemble (the JAX test encodes the whole corpus on every
process for `make_array_from_process_local_data`). Before the counts
cross, the ranks agree on the rule count and the rules' trace
signature (ops/ir.trace_signature); a mismatch raises on every rank.

Nothing falls back: a rank that does not join, or that dies, makes the
others raise within `timeout_s`, and a kernel error ends its rank.
"""

from __future__ import annotations

import datetime
import hashlib
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.encoder import DocBatch
from ..ops.ir import SKIP, CompiledRules, trace_signature
from .device import resolve_device
from .mesh import ShardedBatchEvaluator, slice_bounds

#: seconds a rank waits for the others: to join, and in each collective
DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str = "gloo", timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, rank 0 hosting the rendezvous at
    `coordinator_address` ("host:port", as jax.distributed.initialize
    takes it, or "tcp://host:port"). Raises when the group is not
    whole within `timeout_s`."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes}")
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    dist.init_process_group(
        backend=backend, init_method=address, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group (nothing when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The ranks of the group (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices(device=None) -> List[torch.device]:
    """This rank's devices: with no request (or an unindexed `cuda`),
    card `rank % cards`, so ranks share the cards round-robin and every
    rank of a one-card machine runs on `cuda:0`; else the device asked
    for. With no card and no request this raises."""
    if device is None or torch.device(device) == torch.device("cuda"):
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", process_index() % torch.cuda.device_count())]
    return [resolve_device(device)]


def process_bounds(n_docs: int) -> Tuple[int, int]:
    """This rank's contiguous (lo, hi) range of `n_docs` documents, the
    first `n_docs % ranks` ranks one document longer; a rank past the
    documents gets an empty range."""
    return slice_bounds(n_docs, process_count())[process_index()]


def _signature_words(compiled: CompiledRules) -> List[int]:
    """The trace signature's sha256 as two int64 words."""
    digest = hashlib.sha256(trace_signature(compiled).encode()).digest()
    return [int(w) for w in np.frombuffer(digest[:16], dtype="<i8")]


Groups = Sequence[Tuple[DocBatch, np.ndarray]]


class DistributedEvaluator:
    """A rank's part of a multi-process summary: a ShardedBatchEvaluator
    over `devices` (default `local_devices()`), whose counts are
    all-reduced over the process group `initialize` joined."""

    def __init__(self, compiled: CompiledRules, devices: Optional[Sequence] = None):
        self.compiled = compiled
        self.devices = list(devices) if devices is not None else local_devices()
        self.sharded = ShardedBatchEvaluator(compiled, self.devices)

    def _agree(self, d_local: int) -> int:
        """All-gather (R, signature, d_local) from every rank: raise when
        any rank's rules differ from this rank's, else return this
        rank's first document (the documents of the lower ranks)."""
        n_rules = len(self.compiled.rules)
        mine = torch.tensor([n_rules, *_signature_words(self.compiled), d_local],
                            dtype=torch.int64)
        gathered = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, mine)
        rows = [g.tolist() for g in gathered]
        unlike = [r for r, row in enumerate(rows) if row[:3] != rows[0][:3]]
        if unlike:
            raise RuntimeError(
                "the ranks' rules differ: rule counts "
                f"{[row[0] for row in rows]}, trace signatures "
                f"{'equal' if len({tuple(row[1:3]) for row in rows}) == 1 else 'unequal'} "
                f"(ranks {unlike} differ from rank 0)")
        return sum(row[3] for row in rows[:dist.get_rank()])

    def with_summary(self, local_batch: Union[DocBatch, Groups]):
        """(statuses (d_local, R) int8, start, counts (3, R) int32) of
        this rank's documents: `local_batch` is one DocBatch, or the
        (sub_batch, doc_indices) groups of a bucketed encode, which must
        hold every document of the range (documents outside every
        bucket have no status on the card). `start` is the range's first
        document in the corpus; `counts` are every rank's K7 counts,
        summed over its buckets and cards, then over the group. A rank
        with no documents joins with zeros."""
        groups = ([(local_batch, np.arange(local_batch.n_docs))]
                  if isinstance(local_batch, DocBatch) else list(local_batch))
        d_local = sum(len(idx) for _sub, idx in groups)
        seen = np.zeros(d_local, bool)
        for _sub, idx in groups:
            seen[np.asarray(idx)] = True
        if not seen.all():
            raise ValueError("the groups do not hold every document of the rank's range")
        start = self._agree(d_local)
        n_rules = len(self.compiled.rules)
        statuses = np.full((d_local, n_rules), SKIP, np.int8)
        counts = np.zeros((3, n_rules), np.int64)
        for sub, idx in groups:
            if sub.n_docs == 0:
                continue
            st, c = self.sharded.with_summary(sub)
            statuses[np.asarray(idx)] = st
            counts += c
        total = torch.from_numpy(counts)
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return statuses, start, total.numpy().astype(np.int32)
