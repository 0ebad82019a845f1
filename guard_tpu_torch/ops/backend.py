"""The `validate` path on the device: batch evaluation with oracle
reruns for the reports.

The port of the JAX package's `tpu_validate` (guard_tpu/ops/backend.py:
1695) and its report half (`_report_files`, `_finish_report`):

  0. partition the documents against the result cache (cache/results.py,
     `_result_cache_setup`; on unless --no-result-cache): the cached
     ones replay in pass B, the rest (the delta) go through steps 1-5,
     and a run with no delta encodes nothing and launches nothing;
  1. encode the delta once (`_encode_docs`: the quarantine encode
     under --max-doc-failures, else the ingest pool, else the native
     encoder in process, else the tree encoder), lower every rule file
     up front through the plan layer (ops/plan.py: the in-process memo,
     the disk artifact, else a build), and relocate the shared encode
     into the plan's id namespace; files with function variables get
     their function results precomputed on the host by the CPU
     evaluator (ops/fnvars.precompute_fn_values) and encoded with each
     document into the plan's interner, so the walk's StepFnVar arm
     selects them on the device. Document trees are built only where
     something walks them (`_docs_for`);
  2. evaluate on the device: the files that can share the shared
     encode's program are fused into packs (`plan_packs`, one walk and
     one rim reduction (K3) per (pack, bucket); every (pack, bucket) is
     dispatched before any is collected; --mesh-shape is resolved as the
     JAX package resolves it: with two or more visible cards the packs
     run over R doc shards x C columns of cards, parallel/mesh2d.py,
     with one every shape runs unsharded), and each pack's statuses,
     unsure bits and rim blocks are sliced back per file; the other
     files (function variables, no device rule, a singleton pack,
     --no-pack) evaluate bucket by bucket on their own, each bucket cut
     over the visible cards (parallel/mesh.py), K3 behind each walk. A
     packed dispatch or collect that raises a GuardError (an injected
     `dispatch`/`collect` fault, a GUARD_TPU_DISPATCH_TIMEOUT
     timeout) reruns per file for that bucket on the device, and a
     failed rerun ends the run. On the per-file path an injected fault
     sends its bucket to the host oracle, as in the JAX package; a
     timeout, and any other error, ends the run;
  3. pass A: whole-corpus masks over the rim blocks (`rim_masks`) pick
     the documents whose report needs the oracle (failures unless
     --statuses-only, unsure bits, documents the device did not
     evaluate, host rules, rich output) and those whose per-rule
     statuses must be built at all; under --no-vector-rim no K3 runs
     and pass A walks every (document, rule) status instead;
  4. the reruns: the native C++ oracle (ops/native_oracle.py) where it
     is built and accepts the rules, else the CPU evaluator
     (core/evaluator.py), over a spawn pool (ops/oracle_pool.py) when
     there are enough of them;
  5. pass B: every (rules file, document) pair's report in order, the
     documents pass A settled from one shared template per distinct
     status row and the cached ones replayed; then the structured
     outputs, the store of the delta's results and the exit code.

A device status that differs from the oracle's where no unsure bit was
set is an error (the `TPU/native` and `TPU/CPU` nets, as the JAX
package words them). A quarantined document stands in as `null` and
is left out of every report. Each stage runs in a span of
utils/telemetry.py under the JAX package's name (encode, lower_compile,
pack_compile, dispatch, collect, rim_reduce, oracle, report).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections.abc import Sequence
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..commands.report import rule_statuses_from_root, simplified_report_from_root
from ..core.errors import GuardError
from ..core.evaluator import eval_rules_file
from ..core.qresult import Status
from ..core.scopes import RootScope
from ..core.values import PV
from ..core.values import Path as VPath
from ..utils.faults import FAULT_COUNTERS, InjectedFault, bounded_call, maybe_fail
from ..utils.io import Writer
from ..utils.telemetry import REGISTRY as _TELEMETRY
from ..utils.telemetry import span as _span
from ..utils.telemetry import span_begin as _span_begin
from ..utils.telemetry import span_end as _span_end
from .encoder import Interner, encode_bucketed
from .fnvars import precompute_fn_values, precomputable_fn_vars
from .ir import (
    FAIL,
    PASS,
    SKIP,
    CompiledRules,
    PackIncompatible,
    build_rim_spec,
    compile_rules_file,
    name_groups,
    pack_compatible,
    pack_compiled,
)
from ..parallel.device import (
    EFFICIENCY_COUNTERS,
    evaluate_groups,
    resolve_device,
)
from ..parallel.mesh import ShardedBatchEvaluator

log = logging.getLogger("guard_tpu_torch.backend")

# rule-packing ceiling: packs close when their rule count would exceed
# this (the 249 corpus files' 253 packable rules fit in one pack)
PACK_MAX_RULES = 512

STATUS = {PASS: Status.PASS, FAIL: Status.FAIL, SKIP: Status.SKIP}
_STATUS_VALUES = {s.value for s in Status}

#: the telemetry group "rim", the JAX package's counters:
#: `docs_materialized` counts (document, rules file) pairs whose
#: per-rule status dict was built — failures, unsure bits, host
#: documents, rich output, and every pair under --no-vector-rim —
#: and `docs_settled` those reported from a shared status-row template
RIM_COUNTERS = _TELEMETRY.counter_group(
    "rim", {"docs_materialized": 0, "docs_settled": 0}
)

# the counters of a report run (Evaluation.reruns)
RERUN_KEYS = (
    "materialized",  # (file, doc) pairs whose per-rule statuses were built
    "settled",  # pairs reported from a shared status-row template
    "native_statuses",  # pairs the native statuses prefilter settled
    "native_declines",  # prefilter calls the native oracle declined
    "native_reports",  # reports the native oracle built
    "pooled",  # CPU-evaluator reruns in the spawn pool
    "inline",  # CPU-evaluator reruns in this process
    "pool_failures",  # pools that could not start (reruns went inline)
)


@dataclass
class FileResult:
    """One rules file's device evaluation over the whole batch."""

    rule_file: object  # commands.validate.RuleFile
    compiled: CompiledRules
    # None (both) for a pack whose collect the mesh narrowed to a rim
    # profile (mesh2d.RIM_PROFILES): the statuses stayed on the cards
    statuses: np.ndarray  # (D, R) int8
    unsure: np.ndarray  # (D, R) bool
    # six (D, ...) blocks, kernels.rim_reduce order; a block the rim
    # profile did not ship is None
    rim: tuple
    names: List[str]  # name groups, declaration order
    # documents the device did not evaluate: beyond the last bucket,
    # exotic numbers, a raising function, a lost per-origin result
    host_docs: set = field(default_factory=set)
    # the per-bucket groups this file was evaluated on: the shared ones,
    # or its own when its function results were encoded with the docs
    groups: Optional[list] = None
    # the position of the pack this file was evaluated in
    # (Evaluation.packs), None when it was evaluated on its own
    pack: Optional[int] = None


@dataclass
class Evaluation:
    # [(bucket DocBatch, doc indices)] of the shared encode; None when
    # no file used it (every file with guard rules has function
    # variables and its own groups)
    groups: Optional[list]
    n_docs: int
    interner: Interner
    files: List[FileResult]
    device: torch.device
    # host clock seconds per phase: load (document trees built for the
    # tree encoder of the shared encode), encode (the shared encode's
    # wall, the ingest pool's included, and the per-file encodes of
    # files with function variables), merge (the ingest pool's shard
    # merge, inside encode), fn_precompute (the function values),
    # lower, device (ends when the last bucket is collected); and of the
    # report run: native (native oracle calls), pool (the spawn pool's
    # wall), inline (reruns in this process) and report (the rest:
    # passes A and B and the structured output)
    seconds: Dict[str, float] = field(default_factory=dict)
    # (rules file, document) pairs rerun on the CPU evaluator
    oracle_docs: int = 0
    # the report run's counters, RERUN_KEYS
    reruns: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(RERUN_KEYS, 0))
    # how the shared encode ran (_encode_docs): path "quarantine",
    # "pool", "native" or "tree" (None when no file used it), the
    # ingest workers, and the pool's stats
    ingest: dict = field(default_factory=dict)
    # the member file positions of each pack evaluated
    packs: List[tuple] = field(default_factory=list)


def rim_masks(any_fail, any_unsure, host_mask, has_host_rules: bool,
              rich_mode: bool, statuses_only: bool, show_rich: bool = False):
    """Whole-corpus pass A over the rim blocks, as in the JAX package's
    backend: need_oracle (docs whose answer needs an oracle visit),
    needs_statuses (the subset whose statuses themselves are missing,
    where the native statuses prefilter applies) and materialize (docs
    whose per-rule dict is built at all; the rest settle from a shared
    template)."""
    base = bool(has_host_rules) or bool(rich_mode)
    need_oracle = any_unsure | host_mask
    if base:
        need_oracle = need_oracle | np.True_
    if not statuses_only:
        need_oracle = need_oracle | any_fail
    needs_statuses = any_unsure | host_mask
    if has_host_rules:
        needs_statuses = needs_statuses | np.True_
    materialize = need_oracle | any_fail
    if show_rich:
        materialize = materialize | np.True_
    return need_oracle, needs_statuses, materialize


def _empty_rim(n_docs: int) -> tuple:
    """The rim blocks of a file with no device rule: no name group, and
    every document SKIP."""
    return (
        np.zeros((n_docs, 0), np.int8), np.zeros((n_docs, 0), bool),
        np.full((n_docs, 1), SKIP, np.int8), np.zeros((n_docs, 1), bool),
        np.zeros((n_docs, 1), bool), np.zeros((n_docs, 0), np.int8),
    )


def uses_shared_encode(rule_file) -> bool:
    """Whether a rules file is evaluated on the shared encode: it has
    guard rules and no function variable (those files encode on their
    own, with their function results)."""
    return bool(rule_file.rules.guard_rules) and not precomputable_fn_vars(rule_file.rules)


def plan_packs(items, max_rules: Optional[int] = None):
    """Greedy pack planner over [(file_idx, CompiledRules)] pairs
    already screened with ir.pack_compatible: packs fill in file order
    and close when the next file would push the pack past `max_rules`.
    File order is preserved so packed statuses slice back per file in
    the caller's order."""
    max_rules = PACK_MAX_RULES if max_rules is None else max_rules
    packs, cur, cur_rules = [], [], 0
    for fi, c in items:
        n = len(c.rules)
        if cur and cur_rules + n > max_rules:
            packs.append(cur)
            cur, cur_rules = [], 0
        cur.append((fi, c))
        cur_rules += n
    if cur:
        packs.append(cur)
    return packs


class PackPending:
    """In-flight state between `dispatch_packs` and `collect_packs`:
    per pack (pack, PackedRules, RimSpec, evaluator, handles), each
    handle (doc indices, bucket batch, dispatch handle or None when the
    dispatch failed), the documents no bucket holds, whether K3 rode
    the dispatches (`with_rim`) and, on the 2-D mesh with a consumer
    profile, the rim blocks that left the cards (`rim_blocks`; None is
    the full protocol: statuses, unsure bits and all six blocks).
    `oracle_on_fault` is the ladder of sweep's --rule-shards path: a
    bucket whose collect raises an injected fault goes to the host
    oracle instead of rerunning per file."""

    __slots__ = ("pending", "host_docs", "n_docs", "with_rim", "rim_blocks",
                 "oracle_on_fault")

    def __init__(self, pending, host_docs, n_docs, with_rim=True, rim_blocks=None,
                 oracle_on_fault=False):
        self.pending = pending
        self.host_docs = host_docs
        self.n_docs = n_docs
        self.with_rim = with_rim
        self.rim_blocks = rim_blocks
        self.oracle_on_fault = oracle_on_fault


def dispatch_packs(items, groups, n_docs: int, oversize=(), device=None,
                   prepacked=None, with_rim: bool = True,
                   mesh_shape=None, profile=None) -> PackPending:
    """Dispatch half of the fused multi-rule-file path: pack the
    compatible compiled files (plan_packs; or `prepacked`, the plan
    layer's [(pack, PackedRules, RimSpec)], which skips planning and
    packing) and dispatch EVERY (doc shard, pack, bucket) of the shared
    encode `groups` without collecting. `oversize` are the documents no
    bucket holds. A dispatch that raises a GuardError keeps its bucket
    (handle None) for collect_packs' ladder.

    `with_rim` False is the scalar rim (--no-vector-rim): no K3 rides
    the walks. `mesh_shape` is the --mesh-shape value (None = auto),
    resolved as the JAX package resolves it (parallel/mesh2d.
    resolve_mesh_shape: a malformed value raises, a shape wider than
    the cards warns) against the cards visible for `device`. With one
    visible card every shape runs unsharded; with more, R contiguous
    doc shards (shards outer, packs inner, shard s+1 cut on the
    ShardPrefetcher thread while shard s runs) over C columns of cards.
    `profile` ("validate" | "sweep", mesh2d.RIM_PROFILES) makes the
    sharded collect copy back only the blocks that consumer reads."""
    if (not prepacked) if prepacked is not None else (len(items) < 2):
        return PackPending([], set(), n_docs, with_rim)
    with _span("dispatch", {"files": len(items)}):
        return _dispatch_packs_inner(items, groups, n_docs, oversize, device,
                                     prepacked, with_rim, mesh_shape, profile)


def _dispatch_packs_inner(items, groups, n_docs, oversize, device, prepacked,
                          with_rim, mesh_shape, profile) -> PackPending:
    from ..parallel import mesh, mesh2d

    dev = resolve_device(device)
    visible = mesh.visible_devices(dev)
    shape = mesh2d.resolve_mesh_shape(mesh_shape, len(visible))
    if len(visible) < 2:
        shape = None  # the one-card rule: every shape runs unsharded
    rim_blocks = (
        mesh2d.RIM_PROFILES.get(profile) if (with_rim and shape is not None) else None
    )
    if prepacked is not None:
        planned = prepacked
    else:
        planned = []
        for pack in plan_packs(items):
            if len(pack) < 2:
                continue  # a singleton pack gains nothing over per-file
            try:
                with _span("pack_compile", {"files": len(pack)}):
                    packed = pack_compiled([c for _, c in pack])
                    spec = packed.rim_spec()
            except PackIncompatible as e:
                log.info("pack of %d files fell back to per-file: %s", len(pack), e)
                continue
            planned.append((pack, packed, spec))
    if not planned:
        return PackPending([], set(), n_docs, with_rim, rim_blocks)
    columns = (
        mesh2d.assign_columns([len(p.compiled.rules) for _pk, p, _sp in planned], shape[1])
        if shape is not None else None
    )
    pending = []
    # every pack's evaluator is built before the first dispatch, so the
    # shard loop below is pure dispatch
    for pi, (pack, packed, spec) in enumerate(planned):
        EFFICIENCY_COUNTERS["pack_rule_slots_used"] += len(packed.compiled.rules)
        EFFICIENCY_COUNTERS["pack_rule_slots_capacity"] += PACK_MAX_RULES
        if shape is not None:
            ev = mesh2d.MeshSweepEvaluator(
                packed.compiled, rim_spec=spec if with_rim else None,
                shape=shape, column=columns[pi], rim_blocks=rim_blocks,
                ship_statuses=rim_blocks is None, devices=visible,
            )
        else:
            ev = ShardedBatchEvaluator(packed.compiled, visible,
                                       rim_spec=spec if with_rim else None)
        pending.append((pack, packed, spec, ev, []))
    host_docs = {int(i) for i in oversize}
    if shape is None:
        shard_iter = [(0, 0, groups, ())]
    else:
        bounds = mesh2d.doc_shard_bounds(n_docs, shape[0])
        if len(bounds) > 1:
            from ..parallel.ingest import ShardPrefetcher

            shard_iter = ShardPrefetcher(groups, oversize, bounds)
        else:
            shard_iter = [(0, 0, groups, ())]
    # shards outer, packs inner: a failed bucket dispatch keeps its
    # sub-batch (handle None) for collect_packs' ladder, scoped to that
    # shard's documents
    for s, _lo, sub_groups, _over in shard_iter:
        for _pack, _packed, _spec, ev, handles in pending:
            for sub, idx in sub_groups:
                try:
                    maybe_fail("dispatch")
                    handle = ev.dispatch(sub, shard=s) if shape is not None else ev.dispatch(sub)
                    handles.append((idx, sub, handle))
                except GuardError as e:
                    log.warning("packed dispatch failed for a %d-doc bucket of shard %d "
                                "(%s); will retry per-file at collect", len(idx), s, e)
                    FAULT_COUNTERS["dispatch_fallbacks"] += 1
                    handles.append((idx, sub, None))
    used = EFFICIENCY_COUNTERS["pack_rule_slots_used"]
    cap = EFFICIENCY_COUNTERS["pack_rule_slots_capacity"]
    if cap:
        _TELEMETRY.set_gauge("efficiency.pack_slot_utilization", used / cap)
    return PackPending(pending, host_docs, n_docs, with_rim, rim_blocks)


def collect_packs(pp: PackPending) -> dict:
    """Collect half: wait for every (pack, bucket) and slice the results
    back per file. Returns {file_idx: (statuses (D, R_f) int8, unsure
    (D, R_f) bool, host_docs set, rim)}, `rim` the file's six blocks in
    FileResult's shapes (doc status, any-fail and any-unsure as (D, 1)
    columns), or None when no K3 rode the dispatches. Under a rim
    profile on the mesh (pp.rim_blocks) statuses and unsure bits are
    None and only the profile's blocks are set; the others are None.

    The degradation ladder: a bucket whose dispatch or collect raised a
    GuardError (an injected fault or a timeout) reruns per file for that
    bucket on the pack's cards, and the rim blocks of the recovered
    bucket are recomputed from its recovered status rows by the pack's
    K3. Nothing goes to the host oracle: a per-file rerun that fails (a
    timeout, a kernel that does not build or launch, a CUDA error) ends
    the run. The JAX package sends such a file's documents to its host
    oracle; the port keeps every document it put on the device there.
    The span closes after the last copy to the host."""
    if not pp.pending:
        return {}
    with _span("collect", {"packs": len(pp.pending)}):
        return _collect_packs_inner(pp)


def _collect_packs_inner(pp: PackPending) -> dict:
    results: dict = {}
    d = pp.n_docs
    rim_only = pp.rim_blocks is not None
    for pack, packed, spec, ev, handles in pp.pending:
        n_rules = sum(len(c.rules) for _fi, c in pack)
        statuses = np.full((d, n_rules), SKIP, np.int8)
        unsure = np.zeros((d, n_rules), bool)
        rim = None
        if pp.with_rim:
            rim = [
                np.full((d, w), fill, dt) for w, fill, dt in (
                    (spec.n_groups, SKIP, np.int8), (spec.n_groups, False, bool),
                    (spec.n_files, SKIP, np.int8), (spec.n_files, False, bool),
                    (spec.n_files, False, bool), (spec.n_groups, SKIP, np.int8),
                )
            ]
        for idx, sub, handle in handles:
            if handle is not None:
                try:
                    maybe_fail("collect")
                    got = bounded_call(ev.collect, handle)
                except GuardError as e:
                    if pp.oracle_on_fault:
                        if not isinstance(e, InjectedFault):
                            raise
                        log.warning("sharded pack collect failed for a %d-doc bucket "
                                    "(%s); docs fall back to the host oracle", len(idx), e)
                        FAULT_COUNTERS["dispatch_fallbacks"] += 1
                        FAULT_COUNTERS["oracle_fallbacks"] += 1
                        pp.host_docs.update(int(i) for i in idx)
                        continue
                    log.warning("packed collect failed for a %d-doc bucket (%s); "
                                "retrying per-file", len(idx), e)
                    FAULT_COUNTERS["dispatch_fallbacks"] += 1
                else:
                    if got[0] is not None:
                        statuses[idx] = got[0]
                    if got[1] is not None:
                        unsure[idx] = got[1]
                    if rim is not None:
                        for b, block in enumerate(got[2]):
                            # None: a block the profile did not ship; its
                            # rows stay fill and are never exposed below
                            if block is not None:
                                rim[b][idx] = block
                    continue
            # rung 2: per file for just this bucket, on the pack's
            # cards; a failure here (a timeout among them) ends the run
            for k, (_fi, c) in enumerate(pack):
                seg = packed.segment(k)
                ev2 = ShardedBatchEvaluator(c, ev.devices)
                st, un = bounded_call(lambda: ev2.collect(ev2.dispatch(sub)))
                statuses[idx, seg] = st
                if un is not None:
                    unsure[idx, seg] = un
            if rim is not None:
                for b, block in enumerate(ev.rim_of(statuses[idx], unsure[idx])):
                    rim[b][idx] = block
        for k, (fi, _c) in enumerate(pack):
            seg = packed.segment(k)
            blocks_f = None
            if rim is not None:
                gsl = spec.file_slice(k)
                fsl = slice(k, k + 1)
                blocks_f = (rim[0][:, gsl], rim[1][:, gsl], rim[2][:, fsl],
                            rim[3][:, fsl], rim[4][:, fsl], rim[5][:, gsl])
                if rim_only:
                    blocks_f = tuple(b if i in pp.rim_blocks else None
                                     for i, b in enumerate(blocks_f))
            results[fi] = (None if rim_only else statuses[:, seg],
                           None if rim_only else unsure[:, seg],
                           set(pp.host_docs), blocks_f)
    return results


def _evaluate_packs(items, groups, n_docs: int, oversize=(), device=None,
                    prepacked=None, with_rim: bool = True, mesh_shape=None,
                    profile=None) -> dict:
    """dispatch_packs + collect_packs: every (pack, bucket) dispatches
    before anything collects."""
    return collect_packs(dispatch_packs(items, groups, n_docs, oversize, device, prepacked,
                                        with_rim, mesh_shape, profile))


def evaluate(rule_files, docs, device=None, shared=None, pack_rules: bool = True,
             plan_cache: bool = True, verify_plans: bool = True,
             vector_rim: bool = True, mesh_shape: Optional[str] = None,
             profile: Optional[str] = None) -> Evaluation:
    """Lower every rules file and evaluate it on `device` (CUDA unless
    given). `docs` are the documents' PV trees (a sequence that may
    build them on access). `shared` is the shared encode, (groups,
    oversize, interner) as encoder.encode_bucketed returns them, when
    the caller has it; else it is encoded from `docs` when a file uses
    it (uses_shared_encode).

    With the plan layer on (`plan_cache`) the
    files are lowered through ops/plan.get_plan and the shared encode is
    relocated into the plan's interner (`verify_plans` runs the
    analysis plane's invariants there); otherwise each file is lowered
    against the shared encode's interner. With packing on (`pack_rules`)
    the files on the shared encode evaluate as packs (`mesh_shape`,
    --mesh-shape, is resolved there: unsharded with one visible card,
    doc shards and pack columns with more; `profile`, a
    mesh2d.RIM_PROFILES name, narrows a sharded pack's collect to the
    blocks its consumer reads, leaving that pack's FileResult.statuses
    and unsure None). Every other file runs over the visible cards
    (parallel/mesh.ShardedBatchEvaluator).
    Files with function variables get their function values precomputed
    and are encoded on their own, into the same interner. `vector_rim`
    False (--no-vector-rim) launches no K3: every FileResult.rim is
    None and pass A walks the statuses."""
    from .plan import get_plan, relocate_batch

    dev = resolve_device(device)
    seconds = {"fn_precompute": 0.0, "encode": 0.0}
    if shared is not None:
        interner = shared[2]
        shared = (shared[0], {int(i) for i in shared[1]})
    else:
        interner = Interner()
    if shared is None and any(uses_shared_encode(rf) for rf in rule_files):
        t1 = time.perf_counter()
        with _span("encode", {"docs": len(docs)}):
            groups, oversize, _ = encode_bucketed(docs, interner)
        shared = (groups, {int(i) for i in oversize})
        seconds["encode"] += time.perf_counter() - t1

    t0 = time.perf_counter()
    shared_encode_s = seconds["encode"]
    plan = None
    if plan_cache:
        plan = get_plan(rule_files, verify=verify_plans, device=dev)
        if shared is not None:
            relocate_batch(plan, [b for b, _ in shared[0]], interner, verify=verify_plans)
        interner = plan.interner
    lowered = []
    # one span over the whole lowering without the plan layer, one per
    # function-variable file with it, as in the JAX package
    with _span("lower_compile", {"files": len(rule_files)}) if plan is None else nullcontext():
        for fi, rf in enumerate(rule_files):
            f_groups, f_host = None, set()
            compiled = None if plan is None else plan.compiled[fi]
            if precomputable_fn_vars(rf.rules):
                with (_span("lower_compile", {"files": 1, "mode": "fnvar"})
                      if plan is not None else nullcontext()):
                    t1 = time.perf_counter()
                    fn_vars, fn_vals, fn_err = precompute_fn_values(rf.rules, docs)
                    seconds["fn_precompute"] += time.perf_counter() - t1
                    t1 = time.perf_counter()
                    f_groups, f_oversize, _ = encode_bucketed(
                        docs, interner, fn_values=fn_vals, fn_var_order=fn_vars
                    )
                    seconds["encode"] += time.perf_counter() - t1
                    # a function raised on these documents: the oracle
                    # reruns them and reproduces the error
                    f_host = {int(i) for i in f_oversize} | set(fn_err)
                    compiled = compile_rules_file(rf.rules, interner)
            elif uses_shared_encode(rf):
                f_groups, f_host = shared[0], set(shared[1])
            if compiled is None:
                compiled = compile_rules_file(rf.rules, interner)
            lowered.append((rf, compiled, f_groups, f_host))

    seconds["lower"] = (
        time.perf_counter() - t0 - seconds["fn_precompute"]
        - (seconds["encode"] - shared_encode_s)
    )

    t0 = time.perf_counter()
    d = len(docs)
    packed_results: dict = {}
    pack_members: List[tuple] = []
    if pack_rules and shared is not None:
        items = [
            (fi, c) for fi, (_rf, c, g, _h) in enumerate(lowered)
            if g is shared[0] and pack_compatible(c) is None
        ]
        pending = dispatch_packs(
            items, shared[0], d, shared[1], dev,
            prepacked=plan.prepacked_items() if plan is not None else None,
            with_rim=vector_rim, mesh_shape=mesh_shape, profile=profile,
        )
        pack_members = [tuple(fi for fi, _c in pack) for pack, *_ in pending.pending]
        packed_results = collect_packs(pending)
    pack_of = {fi: p for p, members in enumerate(pack_members) for fi in members}
    files = []
    for fi, (rf, compiled, f_groups, f_host) in enumerate(lowered):
        names = name_groups(compiled.rules)[1]
        if fi in packed_results:
            statuses, unsure, host, rim = packed_results[fi]
            files.append(FileResult(rf, compiled, statuses, unsure, rim, names, host,
                                    f_groups, pack_of[fi]))
            continue
        if not compiled.rules:
            st = np.zeros((d, 0), np.int8)
            un = np.zeros((d, 0), bool)
            files.append(FileResult(rf, compiled, st, un,
                                    _empty_rim(d) if vector_rim else None, [],
                                    f_host, f_groups))
            continue
        spec = build_rim_spec([compiled.rules]) if vector_rim else None
        ev = ShardedBatchEvaluator(compiled, rim_spec=spec, device=dev)
        # documents outside f_groups are left SKIP by evaluate_groups
        with _span("dispatch", {"mode": "per_file", "file": fi}):
            statuses, unsure, host, rim = evaluate_groups(
                ev, len(compiled.rules), f_groups, (), d
            )
        files.append(FileResult(rf, compiled, statuses, unsure, rim, names,
                                f_host | host, f_groups))
    seconds["device"] = time.perf_counter() - t0
    return Evaluation(None if shared is None else shared[0], d, interner, files,
                      dev, seconds, packs=pack_members)


def _materialize_row(name_row, unsure_row, names):
    """One doc's (rule_statuses dict, unsure_rules set) from its rim
    row, in declaration order (the summary table prints that order)."""
    rule_statuses = {}
    unsure_rules = set()
    for g, name in enumerate(names):
        rule_statuses[name] = STATUS[int(name_row[g])]
        if unsure_row is not None and bool(unsure_row[g]):
            unsure_rules.add(name)
    return rule_statuses, unsure_rules


def _status_fields(rule_statuses: Dict[str, Status]) -> dict:
    """The rule lists of a report without clause detail: failing rules
    without checks, as the JAX package builds them."""
    return {
        "not_compliant": [
            {
                "Rule": {
                    "name": n,
                    "metadata": {},
                    "messages": {"custom_message": None, "error_message": None},
                    "checks": [],
                }
            }
            for n, s in sorted(rule_statuses.items())
            if s == Status.FAIL
        ],
        "not_applicable": sorted(
            n for n, s in rule_statuses.items() if s == Status.SKIP
        ),
        "compliant": sorted(
            n for n, s in rule_statuses.items() if s == Status.PASS
        ),
    }


def _settled_template(name_row, names):
    """What every doc with this status row shares: the report's status
    and rule lists, the rule_statuses dict and the doc status. Built
    once per distinct row; a settled doc's report is a thin dict
    around the shared lists."""
    rule_statuses, _ = _materialize_row(name_row, None, names)
    vals = list(rule_statuses.values())
    if Status.FAIL in vals:
        status = Status.FAIL
    elif Status.PASS in vals:
        status = Status.PASS
    else:
        status = Status.SKIP
    fields = {"status": status.value, **_status_fields(rule_statuses)}
    return fields, rule_statuses, status


def _check_parity(rule_statuses, other, unsure_rules, data_file, label: str) -> None:
    """A device status must equal the oracle's, except on rules the
    device flagged unsure (the oracle's answer stands there)."""
    for rn, st in rule_statuses.items():
        ost = other.get(rn)
        if ost is not None and ost != st and rn not in unsure_rules:
            raise GuardError(
                f"TPU/{label} status divergence for rule {rn} on "
                f"{data_file.name}: tpu={st.value} {label.lower()}={ost.value}"
            )


class _ReportAcc:
    """One run's report accumulators: the error count, whether any doc
    failed, every materialized report (structured output) and the JUnit
    cases per document (no suite for a quarantined one)."""

    __slots__ = ("errors", "had_fail", "all_reports", "junit_suites")

    def __init__(self, data_files, quarantined):
        self.errors = 0
        self.had_fail = False
        self.all_reports: List[dict] = []
        self.junit_suites = {
            df.name: [] for di, df in enumerate(data_files) if di not in quarantined
        }


# -- the result cache (cache/results.py) -------------------------------
def _fragment(report: dict, rule_statuses, doc_status) -> dict:
    """One (document, rules file) result as the cache stores it."""
    return {
        "report": report,
        "rs": {n: s.value for n, s in rule_statuses.items()},
        "ds": doc_status.value,
    }


def _result_cache_setup(validate, rule_files, data_files, device):
    """Partition one validate run against the result cache, before any
    encode: a content-addressed lookup per document. Returns None when
    the cache is off (--no-result-cache) or the inputs are not files
    (a payload, merged --input-params documents), else the context
    threaded through _report_files (every entry is read in one batch): `cached` maps a document index to
    its per-rules-file fragments, `delta_idx` lists the documents to
    encode and dispatch, `keys` the store addresses, `capture` and
    `skip_store` are filled in pass B, and `fault_snap` is the fault
    counters' sum at partition time (a run that degraded anywhere
    stores nothing). The key goes through plan.plan_digest, so it holds
    the port's version and the device census: a run on the card and a
    run on the CPU never share an entry."""
    from ..cache import results as rcache
    from .plan import plan_digest

    if not validate.result_cache:
        return None
    if validate.payload or validate.input_params:
        # merged and stdin documents are not content-addressable files
        return None
    cfg = rcache.config_hash(
        mode="validate",
        output_format=validate.output_format,
        show_summary=list(validate.show_summary),
        structured=bool(validate.structured),
        verbose=bool(validate.verbose),
        print_json=bool(validate.print_json),
        statuses_only=bool(validate.statuses_only),
    )
    pdig = plan_digest(rule_files, device)
    n_files = len(rule_files)
    cached: dict = {}
    keys = [rcache.result_key(pdig, rcache.doc_digest(df.content), cfg) for df in data_files]
    delta_idx: list = []
    # reports embed the document's name (the key does not): a
    # same-content document under another name replays only a portable
    # entry, else it is a plain miss
    payloads = rcache.load_entries([(key, df.name) for key, df in zip(keys, data_files)])
    for odi, payload in enumerate(payloads):
        frags = payload.get("files") if payload else None
        if (
            isinstance(frags, list)
            and len(frags) == n_files
            and all(
                isinstance(f, dict)
                and isinstance(f.get("report"), dict)
                and isinstance(f.get("rs"), dict)
                and f.get("ds") in _STATUS_VALUES
                for f in frags
            )
        ):
            cached[odi] = frags
        else:
            delta_idx.append(odi)
    rcache.set_delta_gauge(len(delta_idx), len(data_files))
    return {
        "full_files": list(data_files),
        "cached": cached,
        "delta_idx": delta_idx,
        "keys": keys,
        "capture": {},
        "skip_store": set(),
        "fault_snap": int(sum(FAULT_COUNTERS.values())),
    }


def _replay_cached_doc(validate, writer: Writer, acc: _ReportAcc, data_file, rule_file,
                       frag) -> None:
    """Emit one (document, rules file) result from a cached fragment
    through the report path a fresh evaluation takes (the console chain,
    or the report list and JUnit cases of a structured run, the only
    one that emits them), so every output format replays byte for
    byte."""
    from ..commands.reporters.aware import console_chain
    from ..commands.reporters.junit import JunitTestCase, failure_info_from_report

    report = frag["report"]
    if report.get("name") != data_file.name:
        # a portable entry replayed under another name: the live name,
        # in the same key order (structured output keeps it)
        report = {k: (data_file.name if k == "name" else v) for k, v in report.items()}
    doc_status = Status(frag["ds"])
    if doc_status == Status.FAIL:
        acc.had_fail = True
    if validate.structured:
        acc.all_reports.append(report)
        fname, fmsgs = failure_info_from_report(report)
        acc.junit_suites[data_file.name].append(
            JunitTestCase(
                name=rule_file.name,
                status=doc_status,
                failure_name=fname if doc_status == Status.FAIL else None,
                failure_messages=fmsgs if doc_status == Status.FAIL else None,
            )
        )
        return
    console_chain(
        writer, data_file.name, data_file.content, data_file,
        rule_file.name, doc_status, {n: Status(v) for n, v in frag["rs"].items()},
        report, validate.show_summary, validate.output_format,
    )


def _result_cache_store(rule_files, cache_ctx) -> None:
    """Write back the delta documents' captured fragments, in one
    batch. Never stored: the documents in `skip_store` (quarantined,
    the host oracle's, an oracle error), and the whole run when any
    fault or recovery counter moved since the partition."""
    from ..cache import results as rcache

    if int(sum(FAULT_COUNTERS.values())) != cache_ctx["fault_snap"]:
        return
    n_files = len(rule_files)
    entries = []
    for odi in cache_ctx["delta_idx"]:
        if odi in cache_ctx["skip_store"]:
            continue
        frags = cache_ctx["capture"].get(odi)
        if frags is None or len(frags) != n_files:
            continue
        df = cache_ctx["full_files"][odi]
        # portable: the name appears nowhere in the fragments but each
        # report's own name field, so a same-content document under any
        # name can replay the entry with its own name
        scrubbed = [
            {**f, "report": {k: v for k, v in f["report"].items() if k != "name"}}
            for f in frags
        ]
        portable = df.name not in json.dumps(scrubbed)
        entries.append((cache_ctx["keys"][odi],
                         {"name": df.name, "files": frags, "portable": portable}))
    rcache.store_entries(entries)


def _emit_delta_stats(validate, writer: Writer, cache_ctx) -> None:
    """--delta-stats: one stderr line with the partition (stdout stays
    the bytes of a run without the cache)."""
    if cache_ctx is None or not validate.delta_stats:
        return
    hits = len(cache_ctx["cached"])
    delta = len(cache_ctx["delta_idx"])
    writer.writeln_err(
        f"result-cache: {hits}/{hits + delta} docs cached, {delta} dispatched"
    )


def _report_files(validate, evaluation: Evaluation, data_files, quarantined,
                  writer: Writer, acc: _ReportAcc, cache_ctx=None) -> None:
    """Report half of the device path, one iteration per rules file:
    pass A (which docs need the oracle), the native, pooled and inline
    reruns, and pass B (report emission in document order). Quarantined
    documents are neither rerun nor reported.

    Pass A runs over the rim blocks (the vector rim) or, under
    --no-vector-rim (FileResult.rim None), walks every (document, rule)
    status, materializing every pair. With a `cache_ctx` (the result
    cache) `data_files` are the delta documents: pass A and the reruns
    stay delta-sized, while pass B walks the full document order,
    replaying the cached documents between the fresh ones and capturing
    the fresh ones' fragments for the store."""
    from ..commands.reporters.aware import console_chain
    from ..commands.reporters.junit import JunitTestCase, failure_info_from_report
    from ..commands.validate import _looks_json
    from .native_oracle import (
        NativeEvalError,
        NativeOracle,
        NativeUnsupported,
        overall_status,
    )
    from .oracle_pool import POOL_MAX_WORKERS, POOL_MIN_JOBS, run_oracle_jobs

    counts = evaluation.reruns
    secs = evaluation.seconds
    for key in ("native", "pool", "inline"):
        secs.setdefault(key, 0.0)
    statuses_only = bool(validate.statuses_only)
    # the verbose tree and print-json need the CPU evaluator's record
    # tree: the native oracle stays off for them, as in the JAX package
    rich_tree = validate.verbose or validate.print_json
    rich_mode = validate.structured or rich_tree
    show_rich = bool({"pass", "skip", "all"} & set(validate.show_summary))
    raw_allowed = not validate.input_params
    D = len(data_files)
    full_files = data_files
    delta_pos = None
    if cache_ctx is not None:
        full_files = cache_ctx["full_files"]
        delta_pos = {odi: k for k, odi in enumerate(cache_ctx["delta_idx"])}

    for fi, fr in enumerate(evaluation.files):
        rule_file = fr.rule_file
        native = None
        if not rich_tree:
            try:
                native = NativeOracle(rule_file.rules)
            except NativeUnsupported:
                native = None
        guard_rule_names = [r.rule_name for r in rule_file.rules.guard_rules]

        def _merge_native(raw_statuses):
            """Same-name merge as the report layer (non-SKIP beats
            SKIP, FAIL dominates)."""
            merged = {}
            for name, s in zip(guard_rule_names, raw_statuses):
                st = STATUS[s]
                prev = merged.get(name)
                if prev is None or (prev == Status.SKIP and st != Status.SKIP):
                    merged[name] = st
                elif st == Status.FAIL:
                    merged[name] = Status.FAIL
            return merged

        def _native_prefilter(data_file):
            """The native statuses of one doc: (merged statuses,
            overall) or None on a decline."""
            t0 = time.perf_counter()
            raw = None
            try:
                if raw_allowed and _looks_json(data_file.content):
                    try:
                        raw = native.eval_raw_json(data_file.content)
                    except (NativeUnsupported, NativeEvalError):
                        # e.g. flow-style YAML that sniffs as JSON, or a
                        # decline: the loaded tree is authoritative
                        raw = None
                if raw is None:
                    try:
                        raw = native.eval_doc(data_file.path_value)
                    except (NativeUnsupported, NativeEvalError):
                        raw = None
            finally:
                secs["native"] += time.perf_counter() - t0
            if raw is None:
                return None
            return (_merge_native(raw), STATUS[overall_status(raw)])

        def _native_report(data_file):
            """(report, statuses, status) from the native oracle, or
            None when it declines or errs (the CPU evaluator then
            reproduces a genuine error)."""
            t0 = time.perf_counter()
            try:
                if raw_allowed and _looks_json(data_file.content):
                    try:
                        return native.eval_report_raw(data_file.content, data_file.name)
                    except (NativeUnsupported, NativeEvalError):
                        # possibly flow-style YAML sniffing as JSON:
                        # retry from the loaded tree before giving up
                        pass
                try:
                    return native.eval_report(data_file.path_value, data_file.name)
                except (NativeUnsupported, NativeEvalError):
                    return None
            finally:
                secs["native"] += time.perf_counter() - t0

        def _admit(di, rule_statuses, unsure_rules, doc_status, need_oracle,
                   prefilter):
            """Record one materialized pair for pass B: the native
            statuses prefilter settles it where statuses suffice;
            returns whether it declined."""
            counts["materialized"] += 1
            RIM_COUNTERS["docs_materialized"] += 1
            native_statuses = None
            declined = False
            if need_oracle and native is not None and prefilter:
                native_statuses = _native_prefilter(data_files[di])
                if native_statuses is not None:
                    if statuses_only or native_statuses[1] != Status.FAIL:
                        # statuses suffice: no rich rerun
                        need_oracle = False
                        counts["native_statuses"] += 1
                else:
                    declined = True
            doc_infos[di] = (rule_statuses, unsure_rules, doc_status, native_statuses)
            if need_oracle:
                oracle_dis.append(di)
            return declined

        doc_infos: dict = {}
        oracle_dis = []
        native_declines = 0
        names = fr.names
        name_st = None  # the vector rim's name statuses, for settled docs
        host_mask = np.zeros(D, bool)
        host_mask[sorted(hd for hd in fr.host_docs if hd < D)] = True
        sp_rim = _span_begin(
            "rim_reduce",
            {"docs": D, "file": fi, "mode": "vector" if fr.rim is not None else "scalar"},
        )
        if fr.rim is not None:
            # -- pass A, vector: whole-corpus masks over the rim blocks
            name_st, name_un, doc_st, any_fail, any_un, _last = fr.rim
            need_oracle_v, needs_statuses_v, materialize_v = rim_masks(
                any_fail[:, 0], any_un[:, 0], host_mask, bool(fr.compiled.host_rules),
                rich_mode, statuses_only, show_rich,
            )
            if quarantined:
                qmask = np.zeros(D, bool)
                qmask[list(quarantined)] = True
                need_oracle_v &= ~qmask
                materialize_v &= ~qmask
            prefilter_v = need_oracle_v & (needs_statuses_v | statuses_only)
            for di in np.nonzero(materialize_v)[0]:
                di = int(di)
                if not host_mask[di]:
                    rule_statuses, unsure_rules = _materialize_row(
                        name_st[di], None if name_un is None else name_un[di], names
                    )
                    doc_status = STATUS[int(doc_st[di, 0])]
                else:
                    rule_statuses, unsure_rules = {}, set()
                    doc_status = Status.SKIP
                native_declines += _admit(di, rule_statuses, unsure_rules, doc_status,
                                          bool(need_oracle_v[di]), bool(prefilter_v[di]))
            n_settled = int(D - materialize_v.sum())
            counts["settled"] += n_settled
            RIM_COUNTERS["docs_settled"] += n_settled
        else:
            # -- pass A, scalar (--no-vector-rim): the device statuses,
            # one (document, rule) pair at a time
            statuses, unsure = fr.statuses, fr.unsure
            rules = fr.compiled.rules
            has_host_rules = bool(fr.compiled.host_rules)
            for di in range(D):
                if di in quarantined:
                    continue
                rule_statuses = {}
                unsure_rules = set()
                doc_status = Status.SKIP
                if not host_mask[di]:
                    for ri, crule in enumerate(rules):
                        st = STATUS[int(statuses[di, ri])]
                        # same-name merge as the report layer: non-SKIP
                        # beats SKIP, FAIL dominates
                        prev = rule_statuses.get(crule.name)
                        if prev is None or (prev == Status.SKIP and st != Status.SKIP):
                            rule_statuses[crule.name] = st
                        elif st == Status.FAIL:
                            rule_statuses[crule.name] = Status.FAIL
                        doc_status = doc_status.and_(st)
                        if unsure is not None and bool(unsure[di, ri]):
                            unsure_rules.add(crule.name)
                needs_statuses = has_host_rules or bool(unsure_rules) or bool(host_mask[di])
                need_oracle = (
                    needs_statuses
                    or rich_mode
                    or (not statuses_only
                        and any(s == Status.FAIL for s in rule_statuses.values()))
                )
                native_declines += _admit(di, rule_statuses, unsure_rules, doc_status,
                                          need_oracle, needs_statuses or statuses_only)
        _span_end(sp_rim)
        counts["native_declines"] += native_declines

        # -- the reruns: a spawn pool when there are enough ------------
        # workers rebuild documents from raw content, so merged
        # --input-params documents keep the inline path
        pooled_results = {}
        if (
            (native is None or native_declines >= POOL_MIN_JOBS)
            and len(oracle_dis) >= POOL_MIN_JOBS
            and not validate.input_params
        ):
            workers = min(len(oracle_dis), os.cpu_count() or 1, POOL_MAX_WORKERS)
            if workers > 1:
                jobs = [
                    (0, di, data_files[di].name, data_files[di].content)
                    for di in oracle_dis
                ]
                t0 = time.perf_counter()
                try:
                    with _span("oracle", {"jobs": len(jobs), "workers": workers}):
                        pooled_results = run_oracle_jobs(0, rule_file, jobs, workers)
                except Exception as e:
                    # a pool can fail to start (an embedder's unguarded
                    # __main__ re-executed under spawn): the inline
                    # path is always safe, and the failure is counted
                    log.warning(
                        "oracle rerun pool unavailable (%s); falling back "
                        "to inline reruns", e,
                    )
                    counts["pool_failures"] += 1
                    pooled_results = {}
                secs["pool"] += time.perf_counter() - t0

        # -- pass B: every pair's report, in document order ------------
        # settled docs take their report from the shared per-row
        # template and never enter the JUnit or structured accumulators
        # (a run that emits those materializes every doc)
        oracle_set = set(oracle_dis)
        row_cache: dict = {}
        sp_report = _span_begin("report", {"docs": len(full_files), "file": fi})
        for odi, data_file in enumerate(full_files):
            if cache_ctx is None:
                di = odi
            else:
                frags = cache_ctx["cached"].get(odi)
                if frags is not None:
                    _replay_cached_doc(validate, writer, acc, data_file, rule_file,
                                       frags[fi])
                    continue
                di = delta_pos[odi]
            if di in quarantined:
                if cache_ctx is not None:
                    cache_ctx["skip_store"].add(odi)
                continue
            if di not in doc_infos:
                key = name_st[di].tobytes()
                cached = row_cache.get(key)
                if cached is None:
                    cached = row_cache[key] = _settled_template(name_st[di], names)
                fields, rule_statuses, doc_status = cached
                if doc_status == Status.FAIL:
                    acc.had_fail = True
                report = {"name": data_file.name, "metadata": {}, **fields}
                if not validate.structured:
                    console_chain(
                        writer, data_file.name, data_file.content, data_file,
                        rule_file.name, doc_status, rule_statuses, report,
                        validate.show_summary, validate.output_format,
                    )
                if cache_ctx is not None:
                    cache_ctx["capture"].setdefault(odi, []).append(
                        _fragment(report, rule_statuses, doc_status)
                    )
                continue
            rule_statuses, unsure_rules, doc_status, native_statuses = doc_infos[di]
            need_oracle = di in oracle_set
            if native_statuses is not None and not need_oracle:
                merged, n_doc_status = native_statuses
                _check_parity(rule_statuses, merged, unsure_rules, data_file, "native")
                rule_statuses = merged
                doc_status = n_doc_status
            report = {
                "name": data_file.name,
                "metadata": {},
                "status": doc_status.value,
                **_status_fields(rule_statuses),
            }
            if need_oracle and native is not None and di not in pooled_results:
                # the native report equals simplified_report_from_root
                # over the CPU evaluator's tree
                native_result = _native_report(data_file)
                if native_result is not None:
                    report, oracle_rule_statuses, oracle_status = native_result
                    counts["native_reports"] += 1
                    _check_parity(rule_statuses, oracle_rule_statuses, unsure_rules,
                                  data_file, "native")
                    rule_statuses = oracle_rule_statuses
                    doc_status = oracle_status
                    need_oracle = False
            if need_oracle:
                if di in pooled_results:
                    _key, st_val, p_report, p_statuses, err = pooled_results[di]
                    counts["pooled"] += 1
                    evaluation.oracle_docs += 1
                    if err is not None:
                        writer.writeln_err(err)
                        acc.errors += 1
                        if cache_ctx is not None:
                            cache_ctx["skip_store"].add(odi)
                        continue
                    oracle_status = Status(st_val)
                    report = p_report
                    oracle_rule_statuses = {n: Status(v) for n, v in p_statuses.items()}
                else:
                    counts["inline"] += 1
                    evaluation.oracle_docs += 1
                    t0 = time.perf_counter()
                    try:
                        maybe_fail("oracle", key=data_file.name)
                        scope = RootScope(rule_file.rules, data_file.path_value)
                        oracle_status = eval_rules_file(
                            rule_file.rules, scope, data_file.name
                        )
                    except GuardError as e:
                        writer.writeln_err(str(e))
                        acc.errors += 1
                        if cache_ctx is not None:
                            cache_ctx["skip_store"].add(odi)
                        continue
                    finally:
                        secs["inline"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    root_record = scope.reset_recorder().extract()
                    report = simplified_report_from_root(root_record, data_file.name)
                    oracle_rule_statuses = rule_statuses_from_root(root_record)
                    secs["inline"] += time.perf_counter() - t0
                _check_parity(rule_statuses, oracle_rule_statuses, unsure_rules,
                              data_file, "CPU")
                rule_statuses = oracle_rule_statuses
                doc_status = oracle_status

            if doc_status == Status.FAIL:
                acc.had_fail = True
            acc.all_reports.append(report)
            fname, fmsgs = failure_info_from_report(report)
            acc.junit_suites[data_file.name].append(
                JunitTestCase(
                    name=rule_file.name,
                    status=doc_status,
                    failure_name=fname if doc_status == Status.FAIL else None,
                    failure_messages=fmsgs if doc_status == Status.FAIL else None,
                )
            )
            if not validate.structured:
                console_chain(
                    writer, data_file.name, data_file.content, data_file,
                    rule_file.name, doc_status, rule_statuses, report,
                    validate.show_summary, validate.output_format,
                )
            if cache_ctx is not None:
                # the host oracle's documents (beyond the last bucket,
                # exotic numbers, a raising function, an injected
                # fault) are never stored; unsure-bit and rich-report
                # reruns are deterministic and are
                if host_mask[di]:
                    cache_ctx["skip_store"].add(odi)
                cache_ctx["capture"].setdefault(odi, []).append(
                    _fragment(report, rule_statuses, doc_status)
                )
        _span_end(sp_report)

        if native is not None:
            native.close()


def _finish_report(validate, acc: _ReportAcc, writer: Writer, quarantined,
                   max_df) -> int:
    """Structured-output emission and the exit code: an error wins, then
    more quarantined documents than --max-doc-failures allows (a
    negative limit allows any number), then a failing document."""
    from ..commands.reporters.junit import write_junit
    from ..commands.reporters.sarif import write_sarif
    from ..commands.reporters.structured import write_structured
    from ..commands.validate import (
        ERROR_STATUS_CODE,
        FAILURE_STATUS_CODE,
        SUCCESS_STATUS_CODE,
    )

    if validate.structured:
        if validate.output_format in ("json", "yaml"):
            write_structured(writer, acc.all_reports, validate.output_format)
        elif validate.output_format == "sarif":
            write_sarif(writer, acc.all_reports)
        elif validate.output_format == "junit":
            write_junit(writer, acc.junit_suites)
    if acc.errors > 0:
        return ERROR_STATUS_CODE
    if quarantined:
        FAULT_COUNTERS["quarantined_docs"] += len(quarantined)
        if max_df is not None and 0 <= max_df < len(quarantined):
            return ERROR_STATUS_CODE
    if acc.had_fail:
        return FAILURE_STATUS_CODE
    return SUCCESS_STATUS_CODE


class _DocTrees(Sequence):
    """The documents' PV trees, each built on first access
    (DataFile.path_value) and kept by its DataFile; a quarantined
    document stands in as `null`, so the geometry stays aligned."""

    def __init__(self, data_files, quarantined):
        self._files = data_files
        self._quarantined = quarantined

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, i):
        if i in self._quarantined:
            return PV.null(VPath.root())
        return self._files[i].path_value


def _docs_for(data_files, quarantined):
    """Python document trees, built lazily: on all-JSON corpora the
    native encoder, the device kernels and the native oracle run from
    raw content, and a tree is paid for only by the documents something
    walks (function-variable precompute, the tree encoder, CPU-oracle
    reruns in this process, the console's attribution of failures).
    Quarantined documents stand in as `null`."""
    return _DocTrees(data_files, quarantined)


def _encode_docs(validate, data_files, writer: Writer, seconds: dict):
    """The shared encode, as the JAX package's `_encode_docs`: the
    quarantine encode under --max-doc-failures, else the ingest pool
    (two or more workers, not for payloads or --input-params), else the
    native encoder in this process when every document sniffs as JSON,
    there are no --input-params (their merged trees are the documents)
    and the library is built, else the tree encoder. Returns (shared,
    quarantined, ingest): shared = (groups, oversize, interner) as
    encoder.encode_bucketed returns them, `quarantined` maps a document
    index to its failure record (empty outside --max-doc-failures), and
    `ingest` says which path ran. Sets seconds["encode"], and
    seconds["load"] and seconds["merge"] where they apply."""
    from ..commands.validate import _looks_json
    from ..parallel.ingest import parallel_encode_documents, resolve_ingest_workers
    from .encoder import encode_chunk_texts
    from .native_encoder import encode_json_bucketed, native_available

    t0 = time.perf_counter()
    names = [df.name for df in data_files]
    contents = [df.content for df in data_files]
    quarantined: dict = {}
    workers = resolve_ingest_workers(validate.ingest_workers)
    ingest = {"path": None, "workers": workers}
    shared = None
    if validate.max_doc_failures is not None and not validate.input_params:
        (groups, oversize, interner, q_order, q_msgs, _q_err, q_records,
         q_pvs) = encode_chunk_texts(names, contents)
        shared = (groups, oversize, interner)
        quarantined = dict(zip(q_order, q_records))
        for m in q_msgs:
            writer.writeln_err(m)
        if q_pvs is not None:
            for df, pv in zip(data_files, q_pvs):
                if pv is not None and df._pv is None:
                    df._pv = pv
        ingest["path"] = "quarantine"
    if (
        shared is None
        and workers >= 2
        and len(data_files) >= 2
        and not validate.payload
        and not validate.input_params
    ):
        got = parallel_encode_documents(names, contents, workers)
        if got is not None:
            shared = got[:3]
            ingest.update(path="pool", stats=got[3])
            seconds["merge"] = got[3]["merge_s"]
    if shared is None:
        # the encode in this process: one span over whichever encoder
        # runs (the quarantine encode and the pool's workers record
        # their own)
        with _span("encode", {"docs": len(data_files)}):
            if (
                not validate.input_params
                and all(_looks_json(c) for c in contents)
                and native_available()
            ):
                groups, oversize, interner, err = encode_json_bucketed(contents)
                if err is None:
                    shared = (groups, oversize, interner)
                    ingest["path"] = "native"
            if shared is None:
                t1 = time.perf_counter()
                docs = list(_docs_for(data_files, quarantined))
                seconds["load"] = time.perf_counter() - t1
                shared = encode_bucketed(docs)
                ingest["path"] = "tree"
    seconds["encode"] = time.perf_counter() - t0 - seconds.get("load", 0.0)
    return shared, quarantined, ingest


def tpu_validate(validate, rule_files, data_files, writer: Writer) -> int:
    """Drop-in body of Validate.execute on the device: partition the
    documents against the result cache (unless --no-result-cache),
    encode the delta (the shared encode only when a file uses it, or
    under --max-doc-failures), evaluate it, then report every document
    in order, the cached ones replayed (full reports, or rule statuses
    alone under --statuses-only), and store the fresh results. A run
    whose every document is cached replays them all: no encode, no
    kernel launch, and `validate.last_evaluation` stays None."""
    from ..commands.validate import SUCCESS_STATUS_CODE

    validate.last_evaluation = None
    if not data_files or not rule_files:
        return SUCCESS_STATUS_CODE
    dev = resolve_device(validate.device)
    cache_ctx = _result_cache_setup(validate, rule_files, data_files, dev)
    delta_files = data_files
    if cache_ctx is not None:
        delta_files = [data_files[i] for i in cache_ctx["delta_idx"]]
        if not delta_files:
            acc = _ReportAcc(data_files, {})
            for fi, rule_file in enumerate(rule_files):
                with _span("report", {"docs": len(data_files), "file": fi}):
                    for odi, df in enumerate(data_files):
                        _replay_cached_doc(validate, writer, acc, df, rule_file,
                                           cache_ctx["cached"][odi][fi])
            _emit_delta_stats(validate, writer, cache_ctx)
            return _finish_report(validate, acc, writer, {}, validate.max_doc_failures)
    seconds = {"load": 0.0}
    shared, quarantined, ingest = None, {}, {"path": None}
    if validate.max_doc_failures is not None or any(
        uses_shared_encode(rf) for rf in rule_files
    ):
        shared, quarantined, ingest = _encode_docs(validate, delta_files, writer, seconds)
    else:
        # every tree, in document order, as the JAX package's encode
        # builds them: a document that does not load stops the run here
        t0 = time.perf_counter()
        for df in delta_files:
            df.path_value
        seconds["load"] = time.perf_counter() - t0
    evaluation = evaluate(
        rule_files, _docs_for(delta_files, quarantined), dev, shared=shared,
        pack_rules=validate.pack_rules, plan_cache=validate.plan_cache,
        verify_plans=validate.verify_plans, vector_rim=validate.vector_rim,
        mesh_shape=validate.mesh_shape, profile="validate",
    )
    evaluation.seconds["encode"] += seconds.pop("encode", 0.0)
    evaluation.seconds.update(seconds)
    evaluation.ingest = ingest
    validate.last_evaluation = evaluation
    t0 = time.perf_counter()
    if cache_ctx is None:
        acc = _ReportAcc(data_files, quarantined)
    else:
        # the accumulators span every document; quarantine indices are
        # the delta's
        acc = _ReportAcc(data_files, {cache_ctx["delta_idx"][di] for di in quarantined})
    try:
        _report_files(validate, evaluation, delta_files, quarantined, writer, acc,
                      cache_ctx)
        if cache_ctx is not None:
            _result_cache_store(rule_files, cache_ctx)
            _emit_delta_stats(validate, writer, cache_ctx)
        return _finish_report(validate, acc, writer, quarantined, validate.max_doc_failures)
    finally:
        secs = evaluation.seconds
        secs["report"] = (
            time.perf_counter() - t0 - secs["native"] - secs["pool"] - secs["inline"]
        )


def _segment_view(evaluation: Evaluation, start: int, end: int) -> Evaluation:
    """One request's slice of a shared multi-request evaluation: every
    FileResult's statuses, unsure bits and six rim blocks sliced on the
    document axis, its host documents shifted to indices local to the
    segment, and report counters of its own (reruns, seconds,
    oracle_docs). Raises when a block does not lead with the batch's
    document count: a block laid out otherwise cannot be sliced."""
    from ..parallel.device import _RIM_DTYPES

    d = evaluation.n_docs
    files = []
    for fr in evaluation.files:
        rim = None
        if fr.rim is not None:
            # a block the mesh's rim profile left on the cards is None
            if len(fr.rim) != len(_RIM_DTYPES) or any(
                    b is not None and b.shape[0] != d for b in fr.rim):
                raise GuardError(
                    f"rim blocks of {fr.rule_file.name} do not lead with the "
                    f"{d} documents of the batch: "
                    f"{[None if b is None else tuple(b.shape) for b in fr.rim]}"
                )
            rim = tuple(None if b is None else b[start:end] for b in fr.rim)
        files.append(FileResult(
            fr.rule_file, fr.compiled,
            None if fr.statuses is None else fr.statuses[start:end],
            None if fr.unsure is None else fr.unsure[start:end], rim, fr.names,
            {hd - start for hd in fr.host_docs if start <= hd < end}, fr.groups, fr.pack,
        ))
    return Evaluation(evaluation.groups, end - start, evaluation.interner, files,
                      evaluation.device, ingest=evaluation.ingest, packs=evaluation.packs)


def tpu_validate_multi(requests) -> list:
    """The serve batcher's coalesced path (JAX package:
    guard_tpu/ops/backend.py:1819): several payload requests whose rule
    files share one plan digest evaluate as ONE (documents x rules)
    batch, then each request's report pass runs over its own segment of
    the shared Evaluation (`_segment_view`).

    `requests` is a list of (validate, rule_files, data_files, writer)
    whose rule files have one plan digest and whose evaluation flags are
    equal (serve/batcher.py guarantees both). The shared phase, the
    encode and `evaluate`, runs once under the first request's flags;
    statuses do not depend on the batch a document rides in (the plan
    layer's relocation contract), so each segment's report is the bytes
    of that request run alone. Payload requests never touch the result
    cache (`_result_cache_setup` returns None for them).

    Returns one entry per request: its exit code, or the exception its
    report phase raised (caught so that one request cannot fail its
    peers). An exception of the shared phase propagates: the batcher
    then re-fires every member on its own."""
    from ..commands.validate import ERROR_STATUS_CODE, SUCCESS_STATUS_CODE

    t_dispatch = time.perf_counter()
    base, rule_files, _data, base_writer = requests[0]
    all_data = []
    segments = []
    for _v, _rf, data_files, _w in requests:
        start = len(all_data)
        all_data.extend(data_files)
        segments.append((start, len(all_data)))
    if not all_data or not rule_files:
        # the sequential early return: no report pass, no output
        return [SUCCESS_STATUS_CODE] * len(requests)

    dev = resolve_device(base.device)
    seconds = {"load": 0.0}
    shared, quarantined, ingest = None, {}, {"path": None}
    if any(uses_shared_encode(rf) for rf in rule_files):
        shared, quarantined, ingest = _encode_docs(base, all_data, base_writer, seconds)
    else:
        t0 = time.perf_counter()
        for df in all_data:
            df.path_value
        seconds["load"] = time.perf_counter() - t0
    evaluation = evaluate(
        rule_files, _docs_for(all_data, quarantined), dev, shared=shared,
        pack_rules=base.pack_rules, plan_cache=base.plan_cache,
        verify_plans=base.verify_plans, vector_rim=base.vector_rim,
        mesh_shape=base.mesh_shape, profile="validate",
    )
    evaluation.seconds["encode"] += seconds.pop("encode", 0.0)
    evaluation.seconds.update(seconds)
    evaluation.ingest = ingest
    # the shared phase's wall per coalesced batch (persistent, as the
    # request and queue-wait histograms are)
    _TELEMETRY.histogram("serve_dispatch_seconds", persistent=True).observe(
        time.perf_counter() - t_dispatch
    )

    outcomes: list = []
    for (validate, _rf, data_files, writer), (start, end) in zip(requests, segments):
        validate.last_evaluation = None
        if not data_files:
            outcomes.append(SUCCESS_STATUS_CODE)
            continue
        view = _segment_view(evaluation, start, end)
        validate.last_evaluation = view
        t0 = time.perf_counter()
        try:
            acc = _ReportAcc(data_files, {})
            _report_files(validate, view, data_files, {}, writer, acc)
            outcomes.append(_finish_report(validate, acc, writer, {}, None))
        except GuardError as exc:
            # as Validate.execute words a GuardError of the device path,
            # for this request alone
            writer.writeln_err(str(exc))
            outcomes.append(ERROR_STATUS_CODE)
        except Exception as exc:  # noqa: BLE001 - one request's fault stays its own
            outcomes.append(exc)
        finally:
            secs = view.seconds
            secs["report"] = (
                time.perf_counter() - t0 - secs.get("native", 0.0)
                - secs.get("pool", 0.0) - secs.get("inline", 0.0)
            )
    return outcomes
