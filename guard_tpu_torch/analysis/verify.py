"""Plan/IR verifier: named structural invariants over compiled plans.

A `RulePlan` (ops/plan.py) is the product of three slot-rewriting
passes — lowering, packing, relocation — and a pickle round-trip, any
of which can miscompile or corrupt it in ways the dynamic parity
checks only catch after a dispatch has produced wrong bits. This
module checks the invariants those passes promise, as pure-host
structure walks (no device, no documents):

  segment_offsets_consistent  pack offsets/sizes partition the packed
                              rule list and mirror the member files
  slot_relocation_bijective   every slot reference (lits, bit tables,
                              has-child, chains, structs, named-rule
                              indices) lands inside its table; parallel
                              tables agree on length
  bit_table_width             every (S,) bit table covers exactly the
                              plan interner's current string count
  anchor_chain_domains        folded StepKeyChains keep the >= 2-step,
                              pairwise-disjoint-keys contract and point
                              at the chain_tables spec they were folded
                              from (ir.StepKeyChain docstring)
  rim_name_group_coverage     each pack's RimSpec equals the spec
                              recomputed from its segments (group ids,
                              per-file names, last-rule-wins columns)
  intern_id_domain            a relocated batch's id columns stay
                              inside the plan interner's namespace
  bucket_discipline           the node-bucket ladder is strictly
                              increasing (shape-discipline backstop)

`verify_plan` runs the full structural set (after build_plan and on
every artifact load); `verify_relocation` is the cheap per-chunk
subset (table widths + id domains) run after relocate_batch — sized to
stay inside the <= 2% overhead budget the bench row pins.

Violations are DATA (invariant name + detail), not exceptions: the
plan layer decides policy — a failed verify on artifact load is a
logged miss, a failed verify on fresh lowering raises
`PlanVerifyError` (a hard diagnostic: the bug is in this process's
lowering, not in a stale file).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.errors import GuardError
from ..utils.telemetry import span as _span
from ..ops.ir import (
    CBlockClause,
    CClause,
    CCountClause,
    CNamedRef,
    CWhenBlock,
    StepFilter,
    StepIndex,
    StepKey,
    StepKeyChain,
    StepKeyInterpLit,
    StepKeyInterpVar,
    StepKeysMatch,
    build_rim_spec,
)
from . import ANALYSIS_COUNTERS

#: every invariant name the verifier can emit (docs + mutation tests
#: enumerate against this)
INVARIANTS = (
    "segment_offsets_consistent",
    "slot_relocation_bijective",
    "bit_table_width",
    "anchor_chain_domains",
    "rim_name_group_coverage",
    "intern_id_domain",
    "bucket_discipline",
)


@dataclass
class Violation:
    """One named invariant failure. `where` locates the structure
    (pack index, file position, rule index) in plan coordinates."""

    invariant: str
    detail: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.invariant}{loc}: {self.detail}"


class PlanVerifyError(GuardError):
    """A freshly lowered plan failed verification — a miscompile in
    THIS process, surfaced as a hard diagnostic (exit 5) instead of
    wrong device bits later."""

    def __init__(self, violations: List[Violation]):
        self.violations = violations
        super().__init__(
            "plan verification failed: " + "; ".join(str(v) for v in violations)
        )


# ---------------------------------------------------------------------------
# step/node walks (slot references)
# ---------------------------------------------------------------------------
def _walk_steps(steps, visit_step) -> None:
    for s in steps:
        visit_step(s)
        if isinstance(s, StepKeyChain):
            _walk_steps(s.steps, visit_step)
        elif isinstance(s, StepKeyInterpVar):
            _walk_steps(s.var_steps, visit_step)
        elif isinstance(s, StepFilter):
            for disj in s.conjunctions:
                for n in disj:
                    _walk_node(n, visit_step, lambda n: None)


def _walk_node(node, visit_step, visit_node) -> None:
    visit_node(node)
    if isinstance(node, CClause):
        _walk_steps(node.steps, visit_step)
        if node.rhs_query_steps is not None:
            _walk_steps(node.rhs_query_steps, visit_step)
    elif isinstance(node, CCountClause):
        _walk_steps(node.steps, visit_step)
    elif isinstance(node, CBlockClause):
        _walk_steps(node.query_steps, visit_step)
        for disj in node.inner:
            for n in disj:
                _walk_node(n, visit_step, visit_node)
    elif isinstance(node, CWhenBlock):
        for disj in node.conditions or []:
            for n in disj:
                _walk_node(n, visit_step, visit_node)
        for disj in node.inner:
            for n in disj:
                _walk_node(n, visit_step, visit_node)


def _walk_compiled(comp, visit_step, visit_node) -> None:
    for r in comp.rules:
        for disj in r.conditions or []:
            for n in disj:
                _walk_node(n, visit_step, visit_node)
        for disj in r.conjunctions:
            for n in disj:
                _walk_node(n, visit_step, visit_node)


def _rhs_slots(rhs, visit) -> None:
    if rhs is None:
        return
    visit("lit", rhs.str_slot)
    visit("bits", rhs.bits_slot)
    visit("bits", rhs.lt_slot)
    visit("bits", rhs.le_slot)
    visit("struct", rhs.struct_slot)
    for it in rhs.items or []:
        _rhs_slots(it, visit)


# ---------------------------------------------------------------------------
# individual invariants
# ---------------------------------------------------------------------------
def _check_segments(plan) -> List[Violation]:
    out: List[Violation] = []

    def bad(where: str, detail: str) -> None:
        out.append(Violation("segment_offsets_consistent", detail, where))

    n_files = len(plan.compiled)
    for pi, (pos, packed, _spec) in enumerate(plan.packs):
        where = f"pack {pi}"
        if len(packed.offsets) != len(pos) or len(packed.sizes) != len(pos):
            bad(where, f"{len(pos)} members but {len(packed.offsets)} "
                f"offsets / {len(packed.sizes)} sizes")
            continue
        if len(set(pos)) != len(pos):
            bad(where, f"duplicate member positions {pos}")
        expect = 0
        for k, fi in enumerate(pos):
            if not (0 <= fi < n_files) or plan.compiled[fi] is None:
                bad(f"{where} member {k}", f"file position {fi} is not a "
                    "lowered plan file")
                continue
            if packed.offsets[k] != expect:
                bad(f"{where} member {k}", f"offset {packed.offsets[k]} != "
                    f"running total {expect}")
            if packed.sizes[k] != len(plan.compiled[fi].rules):
                bad(f"{where} member {k}", f"size {packed.sizes[k]} != "
                    f"{len(plan.compiled[fi].rules)} rules in file {fi}")
            expect += packed.sizes[k]
        if expect != len(packed.compiled.rules):
            bad(where, f"segments cover {expect} rules but the pack "
                f"holds {len(packed.compiled.rules)}")
    return out


def _check_slots(plan) -> List[Violation]:
    out: List[Violation] = []
    for label, comp in _plan_parts(plan):
        if len(comp.bit_tables) != len(comp.bit_specs):
            out.append(Violation(
                "slot_relocation_bijective",
                f"{len(comp.bit_tables)} bit_tables vs "
                f"{len(comp.bit_specs)} bit_specs (parallel tables "
                "disagree)", label,
            ))
        n_rules = len(comp.rules)
        bounds = {
            "lit": len(comp.lit_names),
            "bits": len(comp.bit_tables),
            "kidc": len(comp.kidc_tables),
            "chain": len(comp.chain_tables),
            "struct": len(comp.struct_literals),
        }

        def visit(kind: str, slot: int) -> None:
            if not (0 <= slot < bounds[kind]):
                out.append(Violation(
                    "slot_relocation_bijective",
                    f"{kind} slot {slot} out of range "
                    f"[0, {bounds[kind]})", label,
                ))

        def visit_step(s) -> None:
            if isinstance(s, StepKey):
                for x in s.lit_slots:
                    visit("lit", x)
                if s.kc_slot >= 0:
                    visit("kidc", s.kc_slot)
            elif isinstance(s, StepKeyChain):
                visit("chain", s.chain_slot)
            elif isinstance(s, StepKeyInterpLit):
                for x in s.lit_slots:
                    visit("lit", x)
                for x in s.kc_slots:
                    visit("kidc", x)
            elif isinstance(s, StepIndex):
                if s.kc_slot >= 0:
                    visit("kidc", s.kc_slot)
            elif isinstance(s, StepKeysMatch):
                _rhs_slots(s.rhs, lambda k, v: v >= 0 and visit(k, v))

        def visit_node(n) -> None:
            if isinstance(n, CClause):
                _rhs_slots(n.rhs, lambda k, v: v >= 0 and visit(k, v))
            elif isinstance(n, CNamedRef):
                for ri in n.rule_indices:
                    if not (0 <= ri < n_rules):
                        out.append(Violation(
                            "slot_relocation_bijective",
                            f"named-rule index {ri} out of range "
                            f"[0, {n_rules})", label,
                        ))

        if comp.str_empty_slot >= len(comp.bit_tables):
            out.append(Violation(
                "slot_relocation_bijective",
                f"str_empty_slot {comp.str_empty_slot} out of range "
                f"[0, {len(comp.bit_tables)})", label,
            ))
        _walk_compiled(comp, visit_step, visit_node)
    return out


def _check_bit_widths(plan) -> List[Violation]:
    out: List[Violation] = []
    n = len(plan.interner.strings)
    for label, comp in _plan_parts(plan):
        for i, (table, _target) in enumerate(comp.bit_tables):
            if len(table) != n:
                out.append(Violation(
                    "bit_table_width",
                    f"bit table {i} covers {len(table)} strings, "
                    f"interner holds {n}", label,
                ))
        if len(comp.str_empty_bits) != n:
            out.append(Violation(
                "bit_table_width",
                f"str_empty_bits covers {len(comp.str_empty_bits)} "
                f"strings, interner holds {n}", label,
            ))
    return out


def _check_chains(plan) -> List[Violation]:
    out: List[Violation] = []
    for label, comp in _plan_parts(plan):
        n_chains = len(comp.chain_tables)

        def visit_step(s) -> None:
            if not isinstance(s, StepKeyChain):
                return
            if len(s.steps) < 2:
                out.append(Violation(
                    "anchor_chain_domains",
                    f"chain of {len(s.steps)} steps (folding requires "
                    ">= 2)", label,
                ))
                return
            seen: set = set()
            for st in s.steps:
                keys = set(st.key_names)
                if seen & keys:
                    out.append(Violation(
                        "anchor_chain_domains",
                        f"chain steps share key(s) {sorted(seen & keys)} "
                        "(anchor positions are no longer unique)", label,
                    ))
                seen |= keys
            if not (0 <= s.chain_slot < n_chains):
                out.append(Violation(
                    "anchor_chain_domains",
                    f"chain_slot {s.chain_slot} out of range "
                    f"[0, {n_chains})", label,
                ))
                return
            spec = tuple(
                (tuple(st.key_names), st.drop_unres) for st in s.steps
            )
            if comp.chain_tables[s.chain_slot] != spec:
                out.append(Violation(
                    "anchor_chain_domains",
                    f"chain_slot {s.chain_slot} binds spec "
                    f"{comp.chain_tables[s.chain_slot]!r}, the folded "
                    f"steps say {spec!r} (anchor columns would be "
                    "computed for the wrong keys)", label,
                ))

        _walk_compiled(comp, visit_step, lambda n: None)
    return out


def _check_rim(plan) -> List[Violation]:
    out: List[Violation] = []
    for pi, (pos, packed, spec) in enumerate(plan.packs):
        where = f"pack {pi}"
        if len(packed.offsets) != len(pos):
            continue  # already reported by segment_offsets_consistent
        if spec.n_files != len(pos):
            out.append(Violation(
                "rim_name_group_coverage",
                f"rim spec covers {spec.n_files} files, pack has "
                f"{len(pos)}", where,
            ))
            continue
        want = build_rim_spec(
            [packed.compiled.rules[packed.segment(i)]
             for i in range(len(pos))]
        )
        for fld in ("group_ids", "file_ids", "last_ids"):
            if not np.array_equal(getattr(spec, fld), getattr(want, fld)):
                out.append(Violation(
                    "rim_name_group_coverage",
                    f"{fld} disagree with the spec recomputed from the "
                    "pack segments", where,
                ))
        if (spec.n_groups != want.n_groups
                or spec.group_offsets != want.group_offsets
                or spec.file_group_names != want.file_group_names):
            out.append(Violation(
                "rim_name_group_coverage",
                "group numbering/name coverage disagrees with the pack "
                "segments", where,
            ))
    return out


def _check_buckets() -> List[Violation]:
    from ..ops.encoder import NODE_BUCKETS_EXTENDED

    b = tuple(NODE_BUCKETS_EXTENDED)
    if all(x > 0 for x in b) and all(b[i] < b[i + 1] for i in range(len(b) - 1)):
        return []
    return [Violation(
        "bucket_discipline",
        f"node-bucket ladder {b} is not strictly increasing positive",
    )]


def _plan_parts(plan):
    """(label, CompiledRules) for every part whose slots/tables the
    invariants cover — per-file programs and each pack's fused one."""
    for fi, c in enumerate(plan.compiled):
        if c is not None:
            yield f"file {fi}", c
    for pi, (_pos, packed, _spec) in enumerate(plan.packs):
        yield f"pack {pi}", packed.compiled


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def verify_plan(plan) -> List[Violation]:
    """Full structural verification of a RulePlan; returns every
    violation found (empty list = healthy). Pure host."""
    with _span("verify_plan", {"files": len(plan.compiled),
                               "packs": len(plan.packs)}):
        out: List[Violation] = []
        out.extend(_check_segments(plan))
        out.extend(_check_slots(plan))
        out.extend(_check_bit_widths(plan))
        out.extend(_check_chains(plan))
        out.extend(_check_rim(plan))
        out.extend(_check_buckets())
        ANALYSIS_COUNTERS["invariants_checked"] += len(INVARIANTS) - 1
        ANALYSIS_COUNTERS["violations"] += len(out)
        return out


def verify_relocation(plan, batch) -> List[Violation]:
    """The cheap per-chunk subset, run after relocate_batch: every bit
    table must cover the (grown) interner, and the relocated batch's
    string-id columns must stay inside the interner's namespace (a
    stale id would gather garbage rows from every bit table). Length
    compares plus two numpy max reductions — sized for the <= 2%
    overhead bar."""
    out: List[Violation] = []
    n = len(plan.interner.strings)
    for label, comp in _plan_parts(plan):
        for i, (table, _target) in enumerate(comp.bit_tables):
            if len(table) != n:
                out.append(Violation(
                    "bit_table_width",
                    f"bit table {i} covers {len(table)} strings after "
                    f"relocation, interner holds {n}", label,
                ))
                break  # one per part is diagnostic enough
    for col in ("scalar_id", "node_key_id"):
        arr = getattr(batch, col, None)
        if arr is None or arr.size == 0:
            continue
        hi = int(np.max(arr))
        if hi >= n:
            out.append(Violation(
                "intern_id_domain",
                f"batch {col} holds intern id {hi}, plan interner ends "
                f"at {n - 1} (stale/unrelocated ids)",
            ))
    ANALYSIS_COUNTERS["invariants_checked"] += 2
    ANALYSIS_COUNTERS["violations"] += len(out)
    return out


def first_violation_name(violations: List[Violation]) -> Optional[str]:
    return violations[0].invariant if violations else None
