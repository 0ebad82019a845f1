"""The (docs x rules) status evaluator on one device.

The evaluator protocol of the JAX package's ShardedBatchEvaluator
(guard_tpu/parallel/mesh.py:382-546) with the document axis on one
device: `dispatch` copies a bucket's columns to the device and enqueues
the walk (and, with a `rim_spec`, kernel K3's rim reductions) on this
evaluator's CUDA stream without waiting; `collect` waits for that
dispatch and returns host arrays. `with_summary` runs the walk and
kernel K7's per-rule counts (mesh.py:540-546) and waits for both. On
the CPU the same code runs the plain versions of the kernels
synchronously. A dispatch opens the spans `columnarize`, `h2d_copy` and
`walk_enqueue` in turn, and a second `walk_enqueue` around K3's or K7's
launch; a collect opens `device_wait` (utils/telemetry.py).

`evaluate_groups` is the per-file rung of the device path's degradation
ladder, as the JAX package's `evaluate_bucketed` (mesh.py:590-626): the
`dispatch` and `collect` fault points fire before each bucket's
dispatch and collect, each collect runs under
`GUARD_TPU_DISPATCH_TIMEOUT` (utils/faults.bounded_call), and a bucket
whose dispatch or collect raises an injected fault goes to the host
oracle, as in the JAX package. Every other error (a timeout, a kernel
that does not build or launch, a CUDA error) propagates and ends the
run: no real device failure moves a bucket to the CPU.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager, nullcontext
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels as K
from ..ops.encoder import NODE_BUCKETS_EXTENDED, DocBatch, split_batch_by_size
from ..ops.ir import SKIP, CompiledRules, RimSpec
from ..ops.kernels import arrays_from_numpy
from ..ops.tape import build_fused_evaluator
from ..utils.faults import FAULT_COUNTERS, InjectedFault, bounded_call, maybe_fail
from ..utils.telemetry import REGISTRY as _TELEMETRY
from ..utils.telemetry import span as _span

log = logging.getLogger("guard_tpu_torch.device")

#: walks enqueued on a device (one per (program, bucket) dispatch on
#: each card of a mesh that gets documents of the bucket), the
#: telemetry group "dispatch" as in the JAX package; a pack of k files
#: issues one where the files alone issue k. `walks_fused` and
#: `walks_eager` count the walks that ran as the program's tape
#: (ops/tape.py) and those that ran op by op
DISPATCH_COUNTERS = _TELEMETRY.counter_group(
    "dispatch", {"dispatches": 0, "walks_fused": 0, "walks_eager": 0})

#: the telemetry group "efficiency", under the JAX package's names:
#: documents dispatched (one card pads none), the bytes of the columns
#: and literals copied to the device per dispatch and of the statuses,
#: unsure bits and rim blocks copied back per collect, and the rule
#: slots the packs of a run fill against the PACK_MAX_RULES ceiling
#: they close at (ops/backend.dispatch_packs). The mesh's per-shard
#: totals (parallel/mesh2d.py) clear with the group through
#: `_EFFICIENCY_RESET_HOOKS`.
_EFFICIENCY_RESET_HOOKS: list = []


def _run_efficiency_reset_hooks() -> None:
    for hook in list(_EFFICIENCY_RESET_HOOKS):
        hook()


EFFICIENCY_COUNTERS = _TELEMETRY.counter_group("efficiency", {
    "docs_real": 0,
    "host_to_device_bytes": 0,
    "device_to_host_bytes": 0,
    "pack_rule_slots_used": 0,
    "pack_rule_slots_capacity": 0,
}, extra_reset=_run_efficiency_reset_hooks)

# dtypes of the rim blocks, in kernels.rim_reduce order: name status,
# name unsure, doc status, any fail, any unsure, name last
_RIM_DTYPES = (np.int8, bool, np.int8, bool, bool, np.int8)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another. With no card and no explicit request this raises —
    nothing carries on on the CPU by default."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "guard_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' (--device cpu) to run on "
                "the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def build_walk(compiled: CompiledRules):
    """The walk of `compiled`: its tape on the card where the tape
    covers the program, else the eager walk (ops/tape.py); each call
    counts in DISPATCH_COUNTERS' `walks_fused` or `walks_eager`."""
    return build_fused_evaluator(compiled, DISPATCH_COUNTERS)


@contextmanager
def _stream_on(device: torch.device, stream):
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


class DeviceBatchEvaluator:
    """Per-bucket dispatch/collect over one device. `rim_spec`
    (ir.RimSpec) turns on the rim protocol: K3 runs on the device right
    behind each walk and `collect` returns its six blocks as a third
    element. `rim_blocks` (indices 0..5) narrows what `collect` copies
    back to those blocks (the others come back as None), and
    `ship_statuses=False` leaves the (D, R) statuses and unsure bits on
    the card (both None): the rim-only collect of the mesh
    (parallel/mesh2d.RIM_PROFILES). `fn` is the walk of `compiled`
    when the caller already built it (the mesh shares one walk across
    its cards). `last_unsure` holds the (D, R) unsure bits of the last
    __call__ when the program can emit them."""

    def __init__(self, compiled: CompiledRules, device=None,
                 rim_spec: Optional[RimSpec] = None, rim_blocks=None,
                 ship_statuses: bool = True, fn=None):
        self.compiled = compiled
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # an unindexed `cuda` is the thread's current card
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._with_unsure = compiled.needs_unsure
        self._fn = fn if fn is not None else build_walk(compiled)
        self.rim_spec = rim_spec
        self.rim_blocks = None if rim_blocks is None else tuple(rim_blocks)
        # without a rim there is nothing else to return: statuses ship
        self.ship_statuses = bool(ship_statuses) or rim_spec is None
        self._rim_ids = None
        if rim_spec is not None:
            self._rim_ids = tuple(
                torch.from_numpy(np.asarray(a, dtype=np.int32)).to(self.device)
                for a in (rim_spec.group_ids, rim_spec.file_ids, rim_spec.last_ids)
            )
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self.last_unsure: Optional[np.ndarray] = None

    def _on_stream(self):
        """This evaluator's card as the current device and its stream as
        the current stream (nothing on the CPU)."""
        if self._stream is None:
            return nullcontext()
        return _stream_on(self.device, self._stream)

    def _walk(self, batch: DocBatch):
        """Columnarize one batch on the host, copy it to the device and
        enqueue the walk; call on this evaluator's stream. Returns the
        (statuses (D, R) int8, unsure (D, R) bool) device tensors."""
        with _span("columnarize", {"docs": batch.n_docs}):
            arrays = self.compiled.device_arrays(batch)
            lits = self.compiled.lit_values()
        nbytes = int(sum(a.nbytes for a in arrays.values()) + lits.size * 4)
        EFFICIENCY_COUNTERS["docs_real"] += batch.n_docs
        EFFICIENCY_COUNTERS["host_to_device_bytes"] += nbytes
        with _span("h2d_copy", {"bytes": nbytes}):
            t_arrays, t_lits = arrays_from_numpy(arrays, lits, self.device)
        with _span("walk_enqueue"):
            return self._fn(t_arrays, t_lits)

    def dispatch(self, batch: DocBatch):
        """Enqueue one bucket: returns (out, d, rim) without waiting,
        out = (statuses, unsure) device tensors, rim the six K3 blocks
        or None."""
        DISPATCH_COUNTERS["dispatches"] += 1
        with self._on_stream():
            statuses, unsure = self._walk(batch)
            rim = None
            if self.rim_spec is not None:
                with _span("walk_enqueue", {"kernel": "rim_reduce"}):
                    rim = K.rim_reduce(
                        statuses, unsure if self._with_unsure else None,
                        *self._rim_ids, self.rim_spec.n_groups, self.rim_spec.n_files,
                    )
            done = None
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        return (statuses, unsure, done), batch.n_docs, rim

    def collect(self, handle):
        """Wait for a dispatch: (statuses (d, R) int8, unsure (d, R) bool
        or None), plus the rim blocks as a third element with a rim_spec.
        Returns once the copies to the host are done."""
        (statuses, unsure, done), _d, rim = handle
        with _span("device_wait"):
            if done is not None:
                done.synchronize()
            st = un = None
            d2h = 0
            if self.ship_statuses:
                st = statuses.cpu().numpy()
                un = unsure.cpu().numpy() if self._with_unsure else None
                d2h = st.nbytes + (0 if un is None else un.nbytes)
            if self.rim_spec is None:
                EFFICIENCY_COUNTERS["device_to_host_bytes"] += d2h
                return st, un
            blocks = tuple(
                None if self.rim_blocks is not None and i not in self.rim_blocks
                else b.cpu().numpy()
                for i, b in enumerate(rim)
            )
            EFFICIENCY_COUNTERS["device_to_host_bytes"] += d2h + sum(
                b.nbytes for b in blocks if b is not None)
            return st, un, blocks

    def rim_of(self, statuses: np.ndarray, unsure: Optional[np.ndarray]) -> tuple:
        """The six rim blocks (K3, on this evaluator's device) of host
        status rows: a degradation rung that recovered the statuses of a
        bucket recomputes the blocks its failed dispatch lost."""
        st = torch.from_numpy(np.ascontiguousarray(statuses)).to(self.device)
        un = None
        if self._with_unsure and unsure is not None:
            un = torch.from_numpy(np.ascontiguousarray(unsure)).to(self.device)
        with self._on_stream():
            blocks = K.rim_reduce(st, un, *self._rim_ids, self.rim_spec.n_groups,
                                  self.rim_spec.n_files)
        if self._stream is not None:
            self._stream.synchronize()
        return tuple(b.cpu().numpy() for b in blocks)

    def __call__(self, batch: DocBatch) -> np.ndarray:
        st, un = self.collect(self.dispatch(batch))[:2]
        self.last_unsure = un
        return st

    def evaluate_bucketed(self, batch: DocBatch):
        return evaluate_bucketed(self, len(self.compiled.rules), batch)

    def summary_enqueue(self, batch: DocBatch):
        """Enqueue the walk and kernel K7's per-rule PASS, FAIL and SKIP
        counts over the batch's documents, without waiting."""
        with self._on_stream():
            statuses, _unsure = self._walk(batch)
            with _span("walk_enqueue", {"kernel": "rule_summary"}):
                counts = K.rule_summary(statuses, batch.n_docs)
        return statuses, counts

    def summary_collect(self, handle):
        statuses, counts = handle
        with _span("device_wait"):
            if self._stream is not None:
                self._stream.synchronize()
            return statuses.cpu().numpy(), counts.cpu().numpy()

    def with_summary(self, batch: DocBatch):
        """(statuses (d, R) int8, counts (3, R) int32) of one batch at
        its own shape: the walk, then kernel K7's per-rule PASS, FAIL and
        SKIP counts over its d documents, as the JAX package's
        ShardedBatchEvaluator.with_summary (guard_tpu/parallel/mesh.py:540)
        counts the unpadded ones; one card pads nothing. Waits once, for
        both; does not set `last_unsure`."""
        return self.summary_collect(self.summary_enqueue(batch))


def evaluate_bucketed(evaluator: DeviceBatchEvaluator, n_rules: int,
                      batch: DocBatch):
    """Size-bucketed evaluation of a whole batch (split_batch_by_size,
    then evaluate_groups)."""
    groups, oversize = split_batch_by_size(batch, NODE_BUCKETS_EXTENDED)
    return evaluate_groups(evaluator, n_rules, groups, oversize, batch.n_docs)


def evaluate_groups(evaluator: DeviceBatchEvaluator, n_rules: int, groups,
                    oversize, n_docs: int):
    """Evaluate per-bucket (sub_batch, doc_indices) groups of an n_docs
    corpus: every group is dispatched before any is collected, so host
    columnarization of one bucket overlaps the device work of the
    previous one.

    Returns (statuses (D, R) int8, unsure (D, R) bool, host_docs, rim):
    the `oversize` documents (beyond the last bucket, or with numbers
    that have no exact device encoding) stay SKIP and are returned in
    `host_docs`; `rim` is the six (D, ...) rim blocks when the evaluator
    has a rim_spec, else None. A bucket whose dispatch or collect raises
    an InjectedFault stays SKIP (its rim rows too) and joins
    `host_docs`; any other error, a timeout included, propagates."""
    statuses = np.full((n_docs, n_rules), SKIP, np.int8)
    unsure = np.zeros((n_docs, n_rules), bool)
    spec = evaluator.rim_spec
    rim: Optional[List[np.ndarray]] = None
    if spec is not None:
        widths = (spec.n_groups, spec.n_groups, spec.n_files, spec.n_files,
                  spec.n_files, spec.n_groups)
        fills = (SKIP, False, SKIP, False, False, SKIP)
        rim = [
            np.full((n_docs, w), f, dt)
            for w, f, dt in zip(widths, fills, _RIM_DTYPES)
        ]
    host = {int(i) for i in oversize}

    def to_host(stage: str, exc: InjectedFault, idx) -> None:
        # one bucket's injected failure degrades that bucket to the host
        # oracle; every other bucket's results are untouched
        log.warning("device %s failed for a %d-doc bucket (%s); falling back "
                    "to the host oracle", stage, len(idx), exc)
        FAULT_COUNTERS["dispatch_fallbacks"] += 1
        FAULT_COUNTERS["oracle_fallbacks"] += 1
        host.update(int(i) for i in idx)

    pending: List[Tuple[np.ndarray, tuple]] = []
    for sub, idx in groups:
        try:
            maybe_fail("dispatch")
            pending.append((idx, evaluator.dispatch(sub)))
        except InjectedFault as e:
            to_host("dispatch", e, idx)
    for idx, handle in pending:
        try:
            maybe_fail("collect")
            got = bounded_call(evaluator.collect, handle)
        except InjectedFault as e:
            to_host("collect", e, idx)
            continue
        statuses[idx] = got[0]
        if got[1] is not None:
            unsure[idx] = got[1]
        if rim is not None:
            for block, part in zip(rim, got[2]):
                block[idx] = part
    return statuses, unsure, host, None if rim is None else tuple(rim)
