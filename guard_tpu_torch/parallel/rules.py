"""Rule-axis parallelism: the port of the JAX package's
guard_tpu/parallel/rules.py.

A huge compiled rule set splits into dependency-closed groups
(`partition_rules`: named-rule references, `CNamedRef`, stay with their
referents), each group lowers into its own slice (`_slice_compiled`)
and runs over a disjoint, contiguous subset of the cards
(`RuleShardedEvaluator`); a registry of many rule FILES splits at file
granularity instead (`partition_packs`), each group's files packed into
one program (`_pack_group`, `PackShardedEvaluator`). Every group
dispatches before any is collected, so the groups run at once on their
cards, each cutting the full document batch over its own cards
(parallel/mesh.ShardedBatchEvaluator); statuses come back in the
original rule order.

The group count is clamped to min(rule_shards, rules or files, cards),
as in the JAX package (rules.py:216, :338): one card runs one group.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.encoder import DocBatch
from ..ops.ir import (
    CBlockClause,
    CClause,
    CCountClause,
    CNamedRef,
    CompiledRules,
    CWhenBlock,
    StepFilter,
    StepKeyInterpVar,
)
from ..utils.telemetry import span as _span
from . import mesh as _mesh
from .mesh import ShardedBatchEvaluator


def _rule_dependencies(compiled: CompiledRules) -> List[set]:
    """Per-rule sets of referenced rule indices (CNamedRef edges)."""

    deps: List[set] = []

    def walk_steps(steps, acc: set) -> None:
        for s in steps:
            if isinstance(s, StepFilter):
                walk_conjs(s.conjunctions, acc)
            elif isinstance(s, StepKeyInterpVar):
                walk_steps(s.var_steps, acc)

    def walk_node(n, acc: set) -> None:
        if isinstance(n, CNamedRef):
            acc.update(n.rule_indices)
        elif isinstance(n, CClause):
            walk_steps(n.steps + (n.rhs_query_steps or []), acc)
        elif isinstance(n, CCountClause):
            walk_steps(n.steps, acc)
        elif isinstance(n, CBlockClause):
            walk_steps(n.query_steps, acc)
            walk_conjs(n.inner, acc)
        elif isinstance(n, CWhenBlock):
            if n.conditions is not None:
                walk_conjs(n.conditions, acc)
            walk_conjs(n.inner, acc)

    def walk_conjs(conjs, acc: set) -> None:
        for disj in conjs:
            for n in disj:
                walk_node(n, acc)

    for rule in compiled.rules:
        acc: set = set()
        if rule.conditions is not None:
            walk_conjs(rule.conditions, acc)
        walk_conjs(rule.conjunctions, acc)
        deps.append(acc)
    return deps


def partition_rules(compiled: CompiledRules, n_groups: int) -> List[List[int]]:
    """Partition rule indices into <= n_groups dependency-closed groups
    of balanced size (union-find over CNamedRef edges, then greedy
    bin-packing of the components, largest first)."""
    n = len(compiled.rules)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for i, refs in enumerate(_rule_dependencies(compiled)):
        for j in refs:
            union(i, j)

    components: Dict[int, List[int]] = {}
    for i in range(n):
        components.setdefault(find(i), []).append(i)

    groups: List[List[int]] = [[] for _ in range(max(1, n_groups))]
    for comp in sorted(components.values(), key=len, reverse=True):
        min(groups, key=len).extend(comp)
    return [sorted(g) for g in groups if g]


def _slice_compiled(compiled: CompiledRules, indices: List[int]) -> CompiledRules:
    """A CompiledRules containing only `indices`, with CNamedRef
    rule_index fields remapped into the slice (indices must be
    dependency-closed — guaranteed by partition_rules)."""
    remap = {old: new for new, old in enumerate(indices)}

    def fix_node(n):
        if isinstance(n, CNamedRef):
            return CNamedRef(
                rule_indices=[remap[i] for i in n.rule_indices],
                negation=n.negation,
            )
        if isinstance(n, CClause):
            c = copy.copy(n)
            c.steps = [fix_step(s) for s in n.steps]
            if n.rhs_query_steps is not None:
                c.rhs_query_steps = [fix_step(s) for s in n.rhs_query_steps]
            return c
        if isinstance(n, CCountClause):
            c = copy.copy(n)
            c.steps = [fix_step(s) for s in n.steps]
            return c
        if isinstance(n, CBlockClause):
            b = copy.copy(n)
            b.query_steps = [fix_step(s) for s in n.query_steps]
            b.inner = fix_conjs(n.inner)
            return b
        if isinstance(n, CWhenBlock):
            w = copy.copy(n)
            if n.conditions is not None:
                w.conditions = fix_conjs(n.conditions)
            w.inner = fix_conjs(n.inner)
            return w
        return n

    def fix_step(s):
        if isinstance(s, StepFilter):
            f = copy.copy(s)
            f.conjunctions = fix_conjs(s.conjunctions)
            return f
        if isinstance(s, StepKeyInterpVar):
            v = copy.copy(s)
            v.var_steps = [fix_step(x) for x in s.var_steps]
            return v
        return s

    def fix_conjs(conjs):
        return [[fix_node(n) for n in disj] for disj in conjs]

    rules = []
    for i in indices:
        r = copy.copy(compiled.rules[i])
        if r.conditions is not None:
            r.conditions = fix_conjs(r.conditions)
        r.conjunctions = fix_conjs(r.conjunctions)
        rules.append(r)

    return CompiledRules(
        rules=rules,
        host_rules=[],
        interner=compiled.interner,
        str_empty_bits=compiled.str_empty_bits,
        needs_struct_ids=compiled.needs_struct_ids,
        needs_unsure=compiled.needs_unsure,
        bit_tables=compiled.bit_tables,  # slots stay valid: shared specs
        kidc_tables=compiled.kidc_tables,  # ditto (has-child columns)
        chain_tables=compiled.chain_tables,  # ditto (folded key chains)
        str_empty_slot=compiled.str_empty_slot,
        struct_literals=compiled.struct_literals,
        needs_str_rank=compiled.needs_str_rank,
        needs_pairwise=compiled.needs_pairwise,
        needs_fn_origin=compiled.needs_fn_origin,
        fn_vars=compiled.fn_vars,
        lit_names=compiled.lit_names,  # lit slots stay valid: shared table
    )


class RuleShardedEvaluator:
    """(docs x rules) evaluation over a 2-D (rule-groups x docs)
    device decomposition: the cards split into `rule_shards` disjoint
    contiguous groups, each evaluating a dependency-closed slice of the
    rule set over the full document batch cut across its cards. All
    groups dispatch before any collects, so they run at once."""

    rim_spec = None

    def __init__(
        self,
        compiled: CompiledRules,
        rule_shards: int = 2,
        devices: Optional[Sequence] = None,
        device=None,
    ):
        self.compiled = compiled
        devices = list(devices) if devices is not None else _mesh.visible_devices(device)
        rule_shards = max(1, min(rule_shards, len(compiled.rules) or 1, len(devices)))
        self.groups = partition_rules(compiled, rule_shards)
        # disjoint device split covering every device (remainder
        # devices go to the first groups)
        splits = np.array_split(np.arange(len(devices)), len(self.groups))
        self.shards: List[Tuple[ShardedBatchEvaluator, List[int]]] = []
        for idx, dev_idx in zip(self.groups, splits):
            sub_devices = [devices[i] for i in dev_idx]
            sub = _slice_compiled(compiled, idx)
            self.shards.append((ShardedBatchEvaluator(sub, sub_devices), idx))
        self.last_unsure: Optional[np.ndarray] = None

    def dispatch(self, batch: DocBatch):
        """Dispatch EVERY rule-group shard before any collection (the
        groups then run at once on their disjoint cards). Carries the `dispatch` fault-injection
        point so the sweep's bucket-isolation ladder is exercisable on
        the rule-sharded path too."""
        from ..utils.faults import maybe_fail

        maybe_fail("dispatch")
        return [(ev, idx, ev.dispatch(batch)) for ev, idx in self.shards]

    def collect(self, pending):
        d0 = pending[0][2][1]
        n_rules = len(self.compiled.rules)
        statuses = np.empty((d0, n_rules), np.int8)
        unsure = np.zeros((d0, n_rules), bool)
        for ev, idx, handle in pending:
            st, un = ev.collect(handle)
            statuses[:, idx] = st
            if un is not None:
                unsure[:, idx] = un
        return statuses, (unsure if self.compiled.needs_unsure else None)

    def __call__(self, batch: DocBatch) -> np.ndarray:
        """(D, num_rules) int8 statuses in the original rule order."""
        statuses, unsure = self.collect(self.dispatch(batch))
        self.last_unsure = unsure
        return statuses


# per-shard pack memo: the shard composition depends on rule_shards and
# the device census, neither of which is part of the on-disk plan
# artifact's key, so shard packs live in-process only — keyed by member
# CompiledRules identity, which the plan layer keeps stable across
# chunks. Entries carry the member list so the id() keys cannot be
# recycled while cached.
_SHARD_PACK_CACHE: OrderedDict = OrderedDict()
_SHARD_PACK_MAX = 8


def _pack_group(files: List[CompiledRules]):
    """pack_compiled over one shard group, memoized on member identity.
    Cached packs may predate the plan interner's latest relocation, so
    their bit tables are re-extended before reuse (a no-op when the
    interner has not grown)."""
    from ..ops.ir import extend_bit_tables, pack_compiled

    key = tuple(id(f) for f in files)
    hit = _SHARD_PACK_CACHE.get(key)
    if hit is not None:
        _SHARD_PACK_CACHE.move_to_end(key)
        packed = hit[1]
        extend_bit_tables([packed.compiled], packed.compiled.interner)
        return packed
    # per-group pack compile is the sharded path's lowering cost
    with _span("pack_compile", {"files": len(files)}):
        packed = pack_compiled(files)
    _SHARD_PACK_CACHE[key] = (list(files), packed)
    while len(_SHARD_PACK_CACHE) > _SHARD_PACK_MAX:
        _SHARD_PACK_CACHE.popitem(last=False)
    return packed


def partition_packs(compiled_files, n_groups: int) -> List[List[int]]:
    """Partition rule-FILE indices into <= n_groups groups balanced by
    rule count (greedy largest-first), file order preserved inside each
    group. Unlike partition_rules there is no dependency constraint to
    honor: named-rule references cannot cross rule files."""
    n_groups = max(1, n_groups)
    loads = [0] * n_groups
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    for i in sorted(
        range(len(compiled_files)),
        key=lambda i: -len(compiled_files[i].rules),
    ):
        g = loads.index(min(loads))
        groups[g].append(i)
        loads[g] += max(1, len(compiled_files[i].rules))
    return [sorted(g) for g in groups if g]


class PackShardedEvaluator:
    """Rule-axis parallelism with PACKS as the unit: per-file
    CompiledRules partition into <= rule_shards groups balanced by rule
    count, each group's files concatenate into ONE packed program
    (ops.ir.pack_compiled) on its own disjoint group of cards, and
    every group dispatches before any result is collected. Vs
    RuleShardedEvaluator (which splits the rules of one compiled set),
    the pack is both the lowering unit and the sharding unit: a
    registry of many small rule files costs one walk per (group,
    bucket) instead of one per file. Statuses return with files' rules
    concatenated in input order."""

    def __init__(
        self,
        compiled_files: List[CompiledRules],
        rule_shards: int = 2,
        devices: Optional[Sequence] = None,
        with_rim: bool = False,
        device=None,
    ):
        from ..ops.ir import build_rim_spec

        if not compiled_files:
            raise ValueError("no compiled rule files to shard")
        devices = list(devices) if devices is not None else _mesh.visible_devices(device)
        rule_shards = max(
            1, min(rule_shards, len(compiled_files), len(devices))
        )
        self.files = list(compiled_files)
        self.groups = partition_packs(self.files, rule_shards)
        col_base = np.cumsum([0] + [len(c.rules) for c in self.files])
        self._col_base = col_base
        self.n_rules = int(col_base[-1])
        # vectorized-rim protocol: each shard reduces its pack's
        # statuses on its cards (K3 behind each walk) and
        # collect assembles the per-file blocks into GLOBAL arrays in
        # input file order (self.rim_spec indexes them)
        self.rim_spec = (
            build_rim_spec([c.rules for c in self.files]) if with_rim
            else None
        )
        splits = np.array_split(np.arange(len(devices)), len(self.groups))
        self.shards: List[Tuple[ShardedBatchEvaluator, np.ndarray]] = []
        for g, dev_idx in zip(self.groups, splits):
            packed = _pack_group([self.files[i] for i in g])
            cols = np.concatenate(
                [np.arange(col_base[i], col_base[i + 1]) for i in g]
            )
            sub_devices = [devices[i] for i in dev_idx]
            shard_spec = (
                build_rim_spec([self.files[i].rules for i in g])
                if with_rim else None
            )
            self.shards.append(
                (
                    ShardedBatchEvaluator(
                        packed.compiled, sub_devices, rim_spec=shard_spec
                    ),
                    cols,
                    list(g),
                )
            )
        self._with_unsure = any(f.needs_unsure for f in self.files)
        self.last_unsure: Optional[np.ndarray] = None

    def segment(self, k: int) -> slice:
        """File k's status columns, as PackedRules.segment: collect puts
        the files' rules in input order."""
        return slice(int(self._col_base[k]), int(self._col_base[k + 1]))

    def dispatch(self, batch: DocBatch):
        """All pack groups dispatch before any collects (with the
        `dispatch` fault-injection point, as on the unsharded path)."""
        from ..utils.faults import maybe_fail

        maybe_fail("dispatch")
        return [
            (ev, cols, g, ev.dispatch(batch)) for ev, cols, g in self.shards
        ]

    def collect(self, pending):
        from ..ops.ir import SKIP

        d0 = pending[0][3][1]
        statuses = np.empty((d0, self.n_rules), np.int8)
        unsure = np.zeros((d0, self.n_rules), bool)
        spec = self.rim_spec
        rim = None
        if spec is not None:
            rim = (
                np.full((d0, spec.n_groups), SKIP, np.int8),
                np.zeros((d0, spec.n_groups), bool),
                np.full((d0, spec.n_files), SKIP, np.int8),
                np.zeros((d0, spec.n_files), bool),
                np.zeros((d0, spec.n_files), bool),
                np.full((d0, spec.n_groups), SKIP, np.int8),
            )
        for ev, cols, g, handle in pending:
            collected = ev.collect(handle)
            st, un = collected[0], collected[1]
            statuses[:, cols] = st
            if un is not None:
                unsure[:, cols] = un
            if spec is not None:
                shard_rim = collected[2]
                sspec = ev.rim_spec
                for k, fi in enumerate(g):
                    gsl, ssl = spec.file_slice(fi), sspec.file_slice(k)
                    for b in (0, 1, 5):  # name-group-axis blocks
                        rim[b][:, gsl] = shard_rim[b][:, ssl]
                    for b in (2, 3, 4):  # file-axis blocks
                        rim[b][:, fi] = shard_rim[b][:, k]
        if spec is None:
            return statuses, (unsure if self._with_unsure else None)
        return statuses, (unsure if self._with_unsure else None), rim

    def __call__(self, batch: DocBatch) -> np.ndarray:
        collected = self.collect(self.dispatch(batch))
        statuses, unsure = collected[0], collected[1]
        self.last_unsure = unsure
        return statuses
