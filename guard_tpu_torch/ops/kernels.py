"""The evaluation walk: lowered rules (ops/ir.py) over batched columns.

A torch port of `build_doc_evaluator` (guard_tpu/ops/kernels.py:1913)
function for function. Where the JAX program is traced per document and
vmapped, this walk runs eagerly over (D, N) tensors, one document per
row, padded to the node bucket N:

  * a query's current selection is a (D, N) int32 tensor of origin
    labels (0 = unselected; label o = node selected on behalf of origin
    node o-1);
  * each step moves labels from parents to children through K1
    `gather_rows` on the static `node_parent` column;
  * per-origin aggregation (`some`/`match_all`, block and filter
    semantics) and child counts are K2 `segment_sum_rows` histograms;
  * UnResolved accounting is one weighted K2 histogram per query walk;
  * query-RHS compares and `.%var` key interpolation join (origin, key)
    pairs through K4 `set_count_rows` and K5 `distinct_first_rows`, and
    ordering compares fold per-(origin, kind) extremes through K6
    `seg_min_max_rows`, reading them back with K1;
  * everything else — key hits, literal compares, the status lattice —
    is elementwise torch;
  * function-variable roots (StepFnVar), precomputed on the host and
    encoded as orphan subtrees, are selected by key id; per-origin
    results are gated and relabelled by their origin's label in one K1
    gather through the `fn_origin` column.

Statuses are int8 0/1/2 = PASS/FAIL/SKIP: (D, N+1) per origin in node
mode, (D,) per document in scalar (rule-root) mode. The JAX package
picks between a one-hot and a gather formulation of its traversal
primitives (`_use_gather`); both compute the same functions, and this
walk ports the gather semantics only, with its sorted-set joins.

On a card this walk runs as its tape (ops/tape.py): recorded once a
program, on the CPU, with the kernel calls below routed to the thread's
recorder (`K`), and replayed as one tape-kernel launch per dataflow
level between the same kernel calls.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels as _kernels
from ..core.exprs import CmpOperator
from ..core.values import BOOL, FLOAT, INT, LIST, MAP, NULL, STRING
from ..core.values import LOWER_INCLUSIVE, UPPER_INCLUSIVE
from .ir import (
    FAIL,
    PASS,
    SKIP,
    CBlockClause,
    CClause,
    CCountClause,
    CNamedRef,
    CompiledRules,
    CRule,
    CWhenBlock,
    RhsSpec,
    Step,
    StepAllIndices,
    StepAllValues,
    StepFilter,
    StepFnVar,
    StepIndex,
    StepKey,
    StepKeyChain,
    StepKeyInterpLit,
    StepKeyInterpVar,
    StepKeysMatch,
)

_I8 = torch.int8
_I32 = torch.int32

# the recorder of a tape in this thread (ops/tape.py), else None
_RECORDING = threading.local()


class _Kernels:
    """`guard_tpu_torch.kernels` as the walk calls it: each attribute is
    looked up on the module at the call, so a wrapper replaced there is
    the one that runs, except while this thread records a tape, whose
    recorder then stands in for the kernels."""

    def __getattr__(self, name):
        rec = getattr(_RECORDING, "recorder", None)
        if rec is not None and name != "LAUNCHES":
            return rec.kernel(name)
        return getattr(_kernels, name)


K = _Kernels()


# per-origin StepFnVar arms run and the K1 launches they made (a CUDA
# run launches one per arm; the CPU runs the plain version and counts
# nothing), read by chip_smoke.py's kernels line
FNVAR_STEPS = {"per_origin": 0, "k1_launches": 0}


class _DocArrays:
    """The batched columns one evaluation reads: (D, N) tensors from
    CompiledRules.device_arrays, plus the (L,) literal-id table."""

    def __init__(self, arrays: Dict[str, torch.Tensor], lits: torch.Tensor,
                 empty_slot: int):
        self.node_kind = arrays["node_kind"]
        self.node_parent = arrays["node_parent"]
        self.scalar_id = arrays["scalar_id"]
        self.num_hi = arrays["num_hi"]
        self.num_lo = arrays["num_lo"]
        self.child_count = arrays["child_count"]
        self.node_key_id = arrays["node_key_id"]
        self.node_index = arrays["node_index"]
        self.node_parent_kind = arrays["node_parent_kind"]
        # canonical struct ids (loose_eq classes) and string ranks, only
        # for rules with query-RHS compares (ir.py needs_struct_ids,
        # needs_str_rank)
        self.struct_id = arrays.get("struct_id")
        self.str_rank = arrays.get("str_rank")
        # candidate node of each per-origin function-result root, -1
        # elsewhere (ir.py needs_fn_origin)
        self.fn_origin = arrays.get("fn_origin")

        def slots(prefix: str) -> Dict[int, torch.Tensor]:
            w = len(prefix)
            return {
                int(k[w:]): v for k, v in arrays.items()
                if k.startswith(prefix) and k[w:].isdigit()
            }

        # per-struct-literal bool columns (encoder.struct_literal_tri)
        self.stri_m = slots("stri_m")
        self.stri_c = slots("stri_c")
        self.stri_l = slots("stri_l")
        # one bool column per bit-table slot (regex, substring, ordering)
        self.bits = slots("bits")
        # static has-child columns (CompiledRules.kidc_tables)
        self.kidc = slots("kidc")
        # folded key-chain columns: full match, deep miss, anchor index
        self.chF = slots("chF")
        self.chM = slots("chM")
        self.chA = slots("chA")
        self.lits = lits
        self.empty_slot = empty_slot
        self.d, self.n = self.node_kind.shape
        self.device = self.node_kind.device
        self.idx1 = (
            torch.arange(1, self.n + 1, dtype=_I32, device=self.device)
            .expand(self.d, self.n)
        )
        # per-clause "unsure" bits, (D,) bool each; eval_rule ORs the
        # bits its body appended
        self.unsure_acc: List[torch.Tensor] = []
        self.rule_unsure: List[torch.Tensor] = []

    def zeros_b(self) -> torch.Tensor:
        return torch.zeros((self.d, self.n), dtype=torch.bool, device=self.device)

    def ones_b(self) -> torch.Tensor:
        return torch.ones((self.d, self.n), dtype=torch.bool, device=self.device)

    def zeros_i(self, width: int) -> torch.Tensor:
        return torch.zeros((self.d, width), dtype=_I32, device=self.device)

    def full8(self, st: torch.Tensor, scalar: bool) -> torch.Tensor:
        """A (D,) per-document status, broadcast to every origin in
        node mode."""
        return st if scalar else st[:, None].expand(self.d, self.n + 1)

    def const8(self, value: int) -> torch.Tensor:
        return torch.full((self.d,), value, dtype=_I8, device=self.device)


def _where8(cond, a, b) -> torch.Tensor:
    return torch.where(cond, a, b).to(_I8)


# ---------------------------------------------------------------------------
# traversal / aggregation primitives (K1, K2)
# ---------------------------------------------------------------------------


def _sel_root(d: _DocArrays) -> torch.Tensor:
    """(D, N) selection of each document root (node 0, origin label 1)."""
    sel = d.zeros_i(d.n)
    sel[:, 0] = 1
    return sel


def _parent_select(d: _DocArrays, vec: torch.Tensor) -> torch.Tensor:
    """Each node takes its parent's value; 0 at the root and padding."""
    return K.gather_rows(vec, d.node_parent)


def _count_children(d: _DocArrays, pred: torch.Tensor) -> torch.Tensor:
    """(D, N) int32 count of each node's children where pred holds (the
    root and padding carry parent -1 and add nothing)."""
    return K.segment_sum_rows(pred.to(_I32), d.node_parent, d.n)


def _segment_count(d: _DocArrays, sel, pred) -> torch.Tensor:
    """(D, N+1) counts of pred-true selected nodes per origin label."""
    active = pred & (sel > 0)
    return K.segment_sum_rows(active.to(_I32), torch.where(active, sel, 0), d.n + 1)


def _agg(d: _DocArrays, sel, pred, scalar: bool):
    """Per-origin counts in node mode; one masked sum per document in
    scalar (single-origin rule-root) mode."""
    if scalar:
        return (pred & (sel > 0)).sum(dim=1, dtype=_I32)
    return _segment_count(d, sel, pred)


def _select_at(d: _DocArrays, vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec[idx] per row through a static index column."""
    return K.gather_rows(vec, idx)


class _UnresAcc:
    """Deferred UnResolved accounting for one query walk: steps record
    miss labels and counts, the walk pays for one weighted histogram
    (or one masked sum in scalar mode) at the end."""

    __slots__ = ("miss_labels", "miss_count", "touched")

    def __init__(self, d: _DocArrays):
        self.miss_labels = d.zeros_i(d.n)
        self.miss_count = d.zeros_i(d.n)
        self.touched = False

    def add(self, sel, miss) -> None:
        # every call site's `miss` implies sel > 0
        self.miss_labels = torch.where(miss, sel, self.miss_labels)
        self.miss_count = self.miss_count + miss.to(_I32)
        self.touched = True

    def add_count(self, sel, counts) -> None:
        """Charge `counts` (int32 per node, 0 where none) miss events."""
        self.miss_labels = torch.where(counts > 0, sel, self.miss_labels)
        self.miss_count = self.miss_count + counts
        self.touched = True

    def finalize(self, d: _DocArrays, scalar: bool):
        if not self.touched:
            # no step recorded a miss: the counts are structurally zero
            if scalar:
                return torch.zeros((d.d,), dtype=_I32, device=d.device)
            return d.zeros_i(d.n + 1)
        if scalar:
            return self.miss_count.sum(dim=1, dtype=_I32)
        weight = torch.where(self.miss_labels > 0, self.miss_count, 0)
        return K.segment_sum_rows(weight, self.miss_labels, d.n + 1)


# ---------------------------------------------------------------------------
# query walk
# ---------------------------------------------------------------------------


def run_steps(d: _DocArrays, steps: List[Step], sel, rule_statuses=None,
              scalar: bool = False, sel_is_root: Optional[bool] = None):
    """Walk a query: (leaf selection, unresolved counts), the counts
    (D, N+1) per origin or (D,) in single-origin mode. `scalar=True`
    means root-basis evaluation, which defaults `sel_is_root`: the
    first step's parent-select is then the static `node_parent == 0`."""
    if sel_is_root is None:
        sel_is_root = scalar
    acc = _UnresAcc(d)
    for step in steps:
        sel = run_step(d, step, sel, acc, rule_statuses, sel_is_root=sel_is_root)
        sel_is_root = False
    return sel, acc.finalize(d, scalar)


def _key_hit(d: _DocArrays, lit_slots: List[int]) -> torch.Tensor:
    """Node key id equals any of the slots' runtime literal ids (absent
    strings bind to -99 and never match)."""
    kh = d.zeros_b()
    for sl in lit_slots:
        kh = kh | (d.node_key_id == d.lits[sl])
    return kh


def run_step(d: _DocArrays, step: Step, sel, acc: _UnresAcc, rule_statuses=None,
             sel_is_root: bool = False):
    if isinstance(step, StepKeyChain):
        # k >= 2 key steps through one gather: the anchor column points
        # each full-match / deep-miss node at its would-be basis
        # ancestor; from the root basis it degenerates to `anchor == 0`
        first = step.steps[0]
        if sel_is_root:
            P = (d.chA[step.chain_slot] == 0).to(_I32)
        else:
            P = _select_at(d, sel, d.chA[step.chain_slot])
        new_sel = torch.where(d.chF[step.chain_slot], P, 0)
        if not first.drop_unres:
            # position-0 miss: the basis node itself lacks a k_1 child
            resolved = (
                d.kidc[first.kc_slot]
                if first.kc_slot >= 0
                else _count_children(d, _key_hit(d, first.lit_slots)) > 0
            )
            acc.add(sel, (sel > 0) & ~resolved)
        # deep misses (positions 1..k-1)
        acc.add(P, d.chM[step.chain_slot] & (P > 0))
        return new_sel

    if isinstance(step, StepFnVar):
        # precomputed function-result roots (ops/fnvars.py): orphan
        # nodes tagged with the reserved key id; function variables
        # never carry UnResolved entries
        hit = d.node_key_id == step.key_id
        if step.per_origin:
            # per-origin results ('pexpr'): each result root carries its
            # candidate node in fn_origin, and the incoming selection
            # labels each candidate with its own origin label, so
            # sel[fn_origin] both gates the result (0 when its origin is
            # not selected) and relabels it with the origin's label. K1
            # reads 0 at index -1, so gate and relabel are one gather
            idx = torch.where(hit & (d.fn_origin >= 0), d.fn_origin, -1)
            rec = getattr(_RECORDING, "recorder", None)
            if rec is not None:
                # the replay counts the arm around the K1 call it records
                rec.fnvar_next = True
                return _select_at(d, sel, idx)
            before = K.LAUNCHES["gather_rows"]
            out = _select_at(d, sel, idx)
            FNVAR_STEPS["per_origin"] += 1
            FNVAR_STEPS["k1_launches"] += K.LAUNCHES["gather_rows"] - before
            return out
        return hit.to(_I32)

    if sel_is_root:
        psel = (d.node_parent == 0).to(_I32)
    else:
        psel = _parent_select(d, sel)  # label of each node's parent
    if isinstance(step, StepKey):
        kh = _key_hit(d, step.lit_slots)
        new_sel = torch.where(kh, psel, 0)
        if not step.drop_unres:
            resolved = (
                d.kidc[step.kc_slot]
                if step.kc_slot >= 0
                else _count_children(d, kh) > 0
            )
            acc.add(sel, (sel > 0) & ~resolved)
        return new_sel

    if isinstance(step, StepKeyInterpLit):
        # `.%var` with literal strings: exact key lookups, one
        # UnResolved per missing (map, key) pair; non-map candidates
        # UnResolve first
        is_map_sel = (sel > 0) & (d.node_kind == MAP)
        acc.add(sel, (sel > 0) & (d.node_kind != MAP))
        kh_any = d.zeros_b()
        for i, sl in enumerate(step.lit_slots):
            hit = d.node_key_id == d.lits[sl]
            kh_any = kh_any | hit
            has = (
                d.kidc[step.kc_slots[i]]
                if i < len(step.kc_slots)
                else _count_children(d, hit) > 0
            )
            acc.add(sel, is_map_sel & ~has)
        return torch.where(kh_any, psel, 0)

    if isinstance(step, StepKeyInterpVar):
        return _key_interp_var(d, step, sel, psel, acc, rule_statuses)

    if isinstance(step, StepAllValues):
        # `.*`: all children of maps and lists; scalars pass through;
        # empty containers are unresolved
        is_container = (d.node_kind == MAP) | (d.node_kind == LIST)
        keep = torch.where((sel > 0) & ~is_container, sel, 0)
        new_sel = torch.maximum(psel, keep)
        acc.add(sel, (sel > 0) & is_container & (d.child_count == 0))
        return new_sel

    if isinstance(step, StepAllIndices):
        # `[*]`: elements of lists; maps and scalars pass through
        child_sel = torch.where(d.node_parent_kind == LIST, psel, 0)
        keep = torch.where((sel > 0) & (d.node_kind != LIST), sel, 0)
        new_sel = torch.maximum(child_sel, keep)
        acc.add(sel, (sel > 0) & (d.node_kind == LIST) & (d.child_count == 0))
        return new_sel

    if isinstance(step, StepIndex):
        at_idx = d.node_index == step.index
        new_sel = torch.where(at_idx, psel, 0)
        resolved = (
            d.kidc[step.kc_slot]
            if step.kc_slot >= 0
            else _count_children(d, at_idx & (psel > 0)) > 0
        )
        acc.add(sel, (sel > 0) & ((d.node_kind != LIST) | ~resolved))
        return new_sel

    if isinstance(step, StepFilter):
        # list candidates always iterate their elements; map/scalar
        # handling depends on the preceding part (ir.StepFilter)
        is_map = d.node_kind == MAP
        is_list = d.node_kind == LIST
        is_scalar = (sel > 0) & ~is_map & ~is_list
        expand_parent = d.node_parent_kind == LIST
        if step.expand_maps:
            expand_parent = expand_parent | (d.node_parent_kind == MAP)
        elems = torch.where(expand_parent, psel, 0)
        if step.scalar_self:
            # after a variable head: maps and scalars filter themselves
            keep = torch.where((sel > 0) & ~is_list, sel, 0)
        else:
            # scalar candidates are UnResolved either way
            acc.add(sel, is_scalar)
            if step.expand_maps:
                keep = torch.zeros_like(sel)
            else:
                # after `.*`: maps filter themselves
                keep = torch.where((sel > 0) & is_map, sel, 0)
        cand = torch.maximum(elems, keep)  # labeled with the OUTER origin
        cand_self = torch.where(cand > 0, d.idx1, 0)  # each its own origin
        status = eval_conjunctions(d, step.conjunctions, cand_self, rule_statuses)
        selected = (cand > 0) & (status[:, 1:] == PASS)
        return torch.where(selected, cand, 0)

    if isinstance(step, StepKeysMatch):
        # `[ keys == ... ]`: select map values whose key matches;
        # non-map candidates are UnResolved
        match = _rhs_match_on_keys(d, step.rhs, step.op)
        if step.op_not:
            match = ~match
        new_sel = torch.where(match & (d.node_key_id >= 0), psel, 0)
        acc.add(sel, (sel > 0) & (d.node_kind != MAP))
        return new_sel

    raise TypeError(f"unknown step {step!r}")


def _rhs_match_on_keys(d: _DocArrays, rhs: RhsSpec, op: CmpOperator) -> torch.Tensor:
    """Does this node's map key match the keys-filter RHS (Eq/In over
    str/regex/list; bit columns registered with the "key" target)."""
    if rhs.kind == "str":
        if op == CmpOperator.In:
            # `keys in 'lit'`: substring containment
            return d.bits[rhs.bits_slot] & (d.node_key_id >= 0)
        return d.node_key_id == d.lits[rhs.str_slot]
    if rhs.kind == "regex":
        return d.bits[rhs.bits_slot] & (d.node_key_id >= 0)
    if rhs.kind == "list":
        out = d.zeros_b()
        for item in rhs.items:
            out = out | _rhs_match_on_keys(d, item, CmpOperator.Eq)
        return out
    raise TypeError(f"keys filter rhs {rhs.kind}")


# ---------------------------------------------------------------------------
# joins over (origin, key) pairs (K4, K5, K6) and `.%var` interpolation
# ---------------------------------------------------------------------------


def _set_count_sorted(q_org, q_key, q_mask, s_org, s_key, s_mask) -> torch.Tensor:
    """(D, Nq) int32: per masked query entry, the number of masked set
    entries with equal (org, key); the set may be (D, 2N)."""
    return K.set_count_rows(q_org, q_key, q_mask, s_org, s_key, s_mask)


def _in_set_sorted(q_org, q_key, q_mask, s_org, s_key, s_mask) -> torch.Tensor:
    """(D, Nq) bool: a masked query entry has a matching masked set entry."""
    return _set_count_sorted(q_org, q_key, q_mask, s_org, s_key, s_mask) > 0


def _distinct_first_sorted(org, key, mask) -> torch.Tensor:
    """(D, N) bool: True at one representative (the lowest index) per
    distinct masked (org, key)."""
    return K.distinct_first_rows(org, key, mask)


def _seg_min_max_keys(seg, mask, hi, lo, num_segments: int):
    """Per-segment exact (hi, lo) minimum and maximum over masked
    entries, (D, S) int32 each; empty segments read the INT32 sentinels."""
    return K.seg_min_max_rows(seg, mask, hi, lo, num_segments)


def _weighted_count(d: _DocArrays, first, weight, labels) -> torch.Tensor:
    """(D, N+1): the sum of `weight` over the `first` entries per label."""
    return K.segment_sum_rows(
        torch.where(first, weight, 0), torch.where(first, labels, 0), d.n + 1
    )


def _key_interp_var(d: _DocArrays, step: StepKeyInterpVar, sel, psel,
                    acc: _UnresAcc, rule_statuses):
    """`.%var` with a query variable: resolve it from the root, flatten
    one level of lists, then exact-match each string against the
    selected maps' keys (the gather arm of run_step StepKeyInterpVar)."""
    var_sel, var_unres = run_steps(
        d, step.var_steps, _sel_root(d), rule_statuses, scalar=True
    )
    if step.index is not None:
        # `.%var[k]`: the k-th entry in node (= walk) order; with
        # UnResolved entries present that order is ambiguous: unsure
        d.unsure_acc.append(var_unres > 0)
        picked = var_sel > 0
        rank = torch.cumsum(picked.to(_I32), dim=1)
        kth = picked & (rank == step.index + 1)
        oob = step.index >= picked.sum(dim=1, dtype=_I32) + var_unres
        # out of bounds: one UnResolved per map candidate (the non-map
        # check below charges its own); in bounds only the k-th entry
        # takes part
        acc.add(sel, (sel > 0) & (d.node_kind == MAP) & oob[:, None])
        var_sel = torch.where(kth, var_sel, 0)
        var_unres = torch.zeros_like(var_unres)
    pvar = _parent_select(d, var_sel)
    elem = (pvar > 0) & (d.node_parent_kind == LIST)
    flat = ((var_sel > 0) & (d.node_kind != LIST)) | elem
    is_str = d.node_kind == STRING
    good = flat & is_str
    # non-string key values raise NotComparable on the oracle: unsure
    d.unsure_acc.append((flat & ~is_str).any(dim=1))
    is_map_sel = (sel > 0) & (d.node_kind == MAP)
    acc.add(sel, (sel > 0) & (d.node_kind != MAP))
    zeros = d.zeros_i(d.n)
    vs = torch.where(good, d.scalar_id, -1)
    has_key = d.node_key_id >= 0
    kh = _in_set_sorted(zeros, d.node_key_id, has_key, zeros, vs, good)
    # per-map matched-entry counts: distinct (parent, key) children
    # weighted by the variable's multiplicity of that string
    f_pk = _distinct_first_sorted(
        d.node_parent, d.node_key_id, has_key & (d.node_parent >= 0)
    )
    mult = _set_count_sorted(zeros, d.node_key_id, f_pk, zeros, vs, good)
    matched = K.segment_sum_rows(torch.where(f_pk, mult, 0), d.node_parent, d.n)
    miss_counts = good.sum(dim=1, dtype=_I32)[:, None] - matched
    acc.add_count(sel, torch.where(is_map_sel, miss_counts, 0))
    # every UnResolved entry of the variable's own resolution is
    # re-reported per selected candidate
    acc.add_count(sel, torch.where(sel > 0, var_unres[:, None], 0))
    return torch.where(kh, psel, 0)


# ---------------------------------------------------------------------------
# leaf comparisons
# ---------------------------------------------------------------------------


def _num_eq(d: _DocArrays, key) -> torch.Tensor:
    """Exact numeric equality against a literal's (hi, lo) key pair."""
    return (d.num_hi == int(key[0])) & (d.num_lo == int(key[1]))


def _num_lt(d: _DocArrays, key) -> torch.Tensor:
    """Exact numeric < as a lexicographic signed compare of the biased
    int32 (hi, lo) pair (encoder.num_key)."""
    hi, lo = int(key[0]), int(key[1])
    return (d.num_hi < hi) | ((d.num_hi == hi) & (d.num_lo < lo))


def _num_gt(d: _DocArrays, key) -> torch.Tensor:
    hi, lo = int(key[0]), int(key[1])
    return (d.num_hi > hi) | ((d.num_hi == hi) & (d.num_lo > lo))


def _compare_scalar_full(d: _DocArrays, rhs: RhsSpec, op: CmpOperator,
                         loose: bool = False):
    """(match, comparable) of `node <op> literal` per node. Non-comparable
    pairs FAIL regardless of `not`. `loose` switches struct literals to
    loose_eq membership (never NotComparable)."""
    kind = d.node_kind

    if rhs.kind == "never":
        never = d.zeros_b()
        return never, never

    if rhs.kind == "struct":
        if loose:
            m = d.stri_l[rhs.struct_slot]
            return m, m
        return d.stri_m[rhs.struct_slot], d.stri_c[rhs.struct_slot]

    if op == CmpOperator.Eq or op == CmpOperator.In:
        if rhs.kind == "str":
            comparable = kind == STRING
            return comparable & (d.scalar_id == d.lits[rhs.str_slot]), comparable
        if rhs.kind == "regex":
            comparable = kind == STRING
            return comparable & d.bits[rhs.bits_slot], comparable
        if rhs.kind == "num":
            comparable = kind == (INT if rhs.num_kind == INT else FLOAT)
            return comparable & _num_eq(d, rhs.num_key), comparable
        if rhs.kind == "bool":
            comparable = kind == BOOL
            return comparable & _num_eq(d, rhs.num_key), comparable
        if rhs.kind == "null":
            comparable = kind == NULL
            return comparable, comparable
        if rhs.kind == "range":
            comparable = kind == (INT if rhs.range_kind == 9 else FLOAT)
            lo_ok = (
                ~_num_lt(d, rhs.range_lo_key)
                if rhs.range_incl & LOWER_INCLUSIVE
                else _num_gt(d, rhs.range_lo_key)
            )
            hi_ok = (
                ~_num_gt(d, rhs.range_hi_key)
                if rhs.range_incl & UPPER_INCLUSIVE
                else _num_lt(d, rhs.range_hi_key)
            )
            return comparable & lo_ok & hi_ok, comparable
        raise TypeError(f"eq rhs {rhs.kind}")

    # ordering ops: same-kind scalars only
    if rhs.kind == "str":
        comparable = (kind == STRING) & (d.scalar_id >= 0)
        lt = d.bits[rhs.lt_slot]
        le = d.bits[rhs.le_slot]
        if op == CmpOperator.Gt:
            out = ~le
        elif op == CmpOperator.Ge:
            out = ~lt
        elif op == CmpOperator.Lt:
            out = lt
        else:
            out = le
        return comparable & out, comparable
    if rhs.kind == "null":
        # NULL is ordered and all nulls compare equal
        comparable = kind == NULL
        if op in (CmpOperator.Ge, CmpOperator.Le):
            return comparable, comparable
        return d.zeros_b(), comparable
    if rhs.kind != "num":
        # bool/regex/range/list RHS: NotComparable -> FAIL everywhere
        never = d.zeros_b()
        return never, never
    comparable = kind == (INT if rhs.num_kind == INT else FLOAT)
    if op == CmpOperator.Gt:
        out = _num_gt(d, rhs.num_key)
    elif op == CmpOperator.Ge:
        out = ~_num_lt(d, rhs.num_key)
    elif op == CmpOperator.Lt:
        out = _num_lt(d, rhs.num_key)
    else:
        out = ~_num_gt(d, rhs.num_key)
    return comparable & out, comparable


def _compare_scalar(d: _DocArrays, rhs: RhsSpec, op: CmpOperator,
                    loose: bool = False):
    return _compare_scalar_full(d, rhs, op, loose=loose)[0]


def _eval_binary_outcomes(d: _DocArrays, c: CClause, sel_leaf):
    """Per-leaf outcome of a binary op: ((outcome_all, outcome_any) or
    outcome, active). List leaves expand to their elements."""
    rhs = c.rhs
    op = c.op
    is_list_leaf = (sel_leaf > 0) & (d.node_kind == LIST)
    is_scalar_leaf = (sel_leaf > 0) & (d.node_kind != LIST) & (d.node_kind != MAP)
    is_map_leaf = (sel_leaf > 0) & (d.node_kind == MAP)
    n_child = d.child_count

    if op in (CmpOperator.Gt, CmpOperator.Ge, CmpOperator.Lt, CmpOperator.Le):
        # both sides flatten one level and every (lhs, rhs item) pair
        # compares; NotComparable pairs FAIL
        items = rhs.items if rhs.kind == "list" else [rhs]
        node_all = d.ones_b()
        node_any = d.zeros_b()
        for item in items:
            if item.kind == "struct":
                s = d.zeros_b()
            else:
                m_i, c_i = _compare_scalar_full(d, item, op)
                s = c_i & m_i
            node_all = node_all & s
            node_any = node_any | s
        cnt_all = _count_children(d, node_all)
        cnt_any = _count_children(d, node_any)
        outcome_all = torch.where(is_list_leaf, cnt_all == n_child, node_all)
        outcome_any = torch.where(is_list_leaf, cnt_any > 0, node_any)
        return (outcome_all, outcome_any), (sel_leaf > 0)

    if op == CmpOperator.Eq:
        if rhs.kind == "list":
            # list literal RHS: ordered elementwise compare with
            # short-circuit NotComparable; a scalar leaf compares with a
            # one-item list's element
            items = rhs.items
            n_items = len(items)
            prefix = d.child_count == n_items  # all prior items matched
            raised = d.zeros_b()
            for j, item in enumerate(items):
                m_j, c_j = _compare_scalar_full(d, item, CmpOperator.Eq)
                at_j = d.node_index == j
                has_m = _count_children(d, m_j & at_j) > 0
                has_c = _count_children(d, c_j & at_j) > 0
                raised = raised | (prefix & ~has_c)
                prefix = prefix & has_c & has_m
            eq_true = prefix
            comparable_list = ~raised
            if c.op_not:
                outcome = is_list_leaf & comparable_list & ~eq_true
                if n_items == 1:
                    m1, c1 = _compare_scalar_full(d, items[0], CmpOperator.Eq)
                    outcome = torch.where(is_scalar_leaf, c1 & ~m1, outcome)
            else:
                outcome = is_list_leaf & eq_true
                if n_items == 1:
                    m1 = _compare_scalar(d, items[0], CmpOperator.Eq)
                    outcome = torch.where(is_scalar_leaf, m1, outcome)
            return outcome, (sel_leaf > 0)
        # scalar literal RHS: list leaves expand to elements
        match, comparable = _compare_scalar_full(d, rhs, CmpOperator.Eq)
        if c.op_not:
            # `not` only flips comparable pairs
            match = comparable & ~match
        n_child_ok = _count_children(d, match)
        outcome = torch.where(is_list_leaf, n_child_ok == n_child, match)
        outcome_any = torch.where(is_list_leaf, n_child_ok > 0, match)
        if rhs.kind != "struct":
            # map leaves vs scalar literals are NotComparable -> FAIL
            outcome = outcome & ~is_map_leaf
            outcome_any = outcome_any & ~is_map_leaf
        return (outcome, outcome_any), (sel_leaf > 0)

    if op == CmpOperator.In:
        if rhs.kind == "str":
            # string containment, one entry per flattened element
            comparable = d.node_kind == STRING
            m = comparable & d.bits[rhs.bits_slot]
            if c.op_not:
                m = comparable & ~m
            ok_child = _count_children(d, m)
            outcome_all = torch.where(is_list_leaf, ok_child == n_child, m)
            outcome_any = torch.where(is_list_leaf, ok_child > 0, m)
            return (outcome_all, outcome_any), (sel_leaf > 0)
        if rhs.kind == "list":
            # membership via loose_eq: pure inversion under `not`
            m = d.zeros_b()
            for item in rhs.items:
                m = m | _compare_scalar(d, item, CmpOperator.Eq, loose=True)
            if rhs.items and rhs.items[0].kind == "struct" and rhs.items[0].struct_is_list:
                # first item is a LIST: whole-value membership
                return (~m if c.op_not else m), (sel_leaf > 0)
            # list leaf: ALL elements in rhs; not_in: NO element in rhs
            # and the list is non-empty
            in_child = _count_children(d, m)
            if c.op_not:
                outcome = torch.where(
                    is_list_leaf, (in_child == 0) & (n_child > 0), ~m
                )
            else:
                outcome = torch.where(is_list_leaf, in_child == n_child, m)
            return outcome, (sel_leaf > 0)
        # scalar RHS: NotComparable stays FAIL through `not`; a list lhs
        # vs a non-list RHS is NotComparable
        m, comparable = _compare_scalar_full(d, rhs, CmpOperator.Eq)
        if c.op_not:
            m = comparable & ~m
        return m & ~is_list_leaf, (sel_leaf > 0)

    raise TypeError(f"binary op {op}")


# ---------------------------------------------------------------------------
# query-RHS compares: LHS query vs RHS query, per origin
# ---------------------------------------------------------------------------

_KIND_CLASSES = 5  # INT, FLOAT, STRING, NULL, other
_NOT_ORDER = {
    CmpOperator.Lt: CmpOperator.Ge, CmpOperator.Ge: CmpOperator.Lt,
    CmpOperator.Le: CmpOperator.Gt, CmpOperator.Gt: CmpOperator.Le,
}


def _flatten_one_level(d: _DocArrays, sel_v) -> torch.Tensor:
    """Selected LIST values are replaced by their elements (one level);
    everything else keeps its label."""
    psel = _parent_select(d, sel_v)
    child = torch.where((d.node_parent_kind == LIST) & (psel > 0), psel, 0)
    keep = torch.where((sel_v > 0) & (d.node_kind != LIST), sel_v, 0)
    return torch.maximum(child, keep)


def _query_rhs_sides(d: _DocArrays, c: CClause, sel, rule_statuses,
                     sel_is_root: bool):
    """Walk both sides: (lhs_sel, lhs_unres, rhs_sel, rhs_unres, n_lhs,
    n_rhs), counts (D, N+1) per origin. A root-bound RHS is one shared
    set resolved from the root, its counts broadcast to every origin."""
    lhs_sel, lhs_unres = run_steps(
        d, c.steps, sel, rule_statuses, sel_is_root=sel_is_root
    )
    if c.rhs_query_from_root:
        rhs_sel, rhs_unres_s = run_steps(
            d, c.rhs_query_steps, _sel_root(d), rule_statuses, scalar=True
        )
        wide = (d.d, d.n + 1)
        rhs_unres = rhs_unres_s[:, None].expand(wide)
        n_rhs = (rhs_sel > 0).sum(dim=1, dtype=_I32)[:, None].expand(wide)
    else:
        rhs_sel, rhs_unres = run_steps(
            d, c.rhs_query_steps, sel, rule_statuses, sel_is_root=sel_is_root
        )
        n_rhs = _segment_count(d, rhs_sel, d.ones_b())
    n_lhs = _segment_count(d, lhs_sel, d.ones_b())
    return lhs_sel, lhs_unres, rhs_sel, rhs_unres, n_lhs, n_rhs


def _lex_lt(ah, al, bh, bl) -> torch.Tensor:
    return (ah < bh) | ((ah == bh) & (al < bl))


def _ordering_outcomes_sorted(d: _DocArrays, c: CClause, lf, rf, lhs_here,
                              rhs_here):
    """(fail_per_i, pass_per_i) of an ordering op against a query RHS:
    in the same-kind total order '∃ y: x < y' is 'x < max(same-kind rhs
    of my origin)' (and dually), so per-(origin, kind class) counts (K2)
    and extremes (K6), read back per entry (K1), decide every element.
    NULLs all compare equal; cross-kind or non-orderable pairs FAIL."""
    kinds = _KIND_CLASSES
    kind = d.node_kind
    kc = torch.where(
        kind == INT, 0,
        torch.where(kind == FLOAT, 1,
                    torch.where(kind == STRING, 2, torch.where(kind == NULL, 3, 4))),
    ).to(_I32)
    is_str = kind == STRING
    key_hi = torch.where(is_str, d.str_rank, d.num_hi)
    key_lo = torch.where(is_str, 0, d.num_lo).to(_I32)
    # shared-RHS labels are 1 (a root-basis run); per origin otherwise
    nseg = (d.n + 1) * kinds
    seg = rf * kinds + kc
    cnt = K.segment_sum_rows(rhs_here.to(_I32), torch.where(rhs_here, seg, 0), nseg)
    min_hi, min_lo, max_hi, max_lo = _seg_min_max_keys(seg, rhs_here, key_hi, key_lo, nseg)

    # `not` complements within the same-kind total order
    op = _NOT_ORDER[c.op] if c.op_not else c.op
    o_look = torch.ones_like(lf) if c.rhs_query_from_root else lf
    seg_same = o_look * kinds + kc
    cnt_same = K.gather_rows(cnt, seg_same)
    per_origin = cnt.view(d.d, d.n + 1, kinds).sum(dim=2, dtype=_I32)
    total = K.gather_rows(per_origin, o_look)
    mnh = K.gather_rows(min_hi, seg_same)
    mnl = K.gather_rows(min_lo, seg_same)
    mxh = K.gather_rows(max_hi, seg_same)
    mxl = K.gather_rows(max_lo, seg_same)

    if op == CmpOperator.Lt:
        ok_some = _lex_lt(key_hi, key_lo, mxh, mxl)
        nok_some = ~_lex_lt(key_hi, key_lo, mnh, mnl)
        null_ok = False
    elif op == CmpOperator.Le:
        ok_some = ~_lex_lt(mxh, mxl, key_hi, key_lo)
        nok_some = _lex_lt(mnh, mnl, key_hi, key_lo)
        null_ok = True
    elif op == CmpOperator.Gt:
        ok_some = _lex_lt(mnh, mnl, key_hi, key_lo)
        nok_some = ~_lex_lt(mxh, mxl, key_hi, key_lo)
        null_ok = False
    else:  # Ge
        ok_some = ~_lex_lt(key_hi, key_lo, mnh, mnl)
        nok_some = _lex_lt(key_hi, key_lo, mxh, mxl)
        null_ok = True

    has_same = cnt_same > 0
    orderable_x = kc <= 2
    null_same = (kc == 3) & has_same
    pass_per_i = lhs_here & ((orderable_x & has_same & ok_some) | (null_same & null_ok))
    fail_cross = (total - torch.where(kc <= 3, cnt_same, 0)) > 0
    fail_same = orderable_x & has_same & nok_some
    fail_per_i = lhs_here & (fail_cross | fail_same | (null_same & (not null_ok)))
    return fail_per_i, pass_per_i


def _eval_query_rhs_ordering(d: _DocArrays, c: CClause, sel, rule_statuses,
                             sel_is_root: bool = False) -> torch.Tensor:
    """Ordering ops (< <= > >=) against a query RHS: every (lhs, rhs)
    pair of the flattened value sets compares in the same-kind total
    order (INT/FLOAT by the exact (hi, lo) keys, STRING by rank, NULLs
    equal); `not` flips comparable pairs, NotComparable pairs FAIL."""
    lhs_sel, lhs_unres, rhs_sel, rhs_unres, n_lhs, n_rhs = _query_rhs_sides(
        d, c, sel, rule_statuses, sel_is_root
    )
    lf = _flatten_one_level(d, lhs_sel)
    rf = _flatten_one_level(d, rhs_sel)
    fail_per_i, pass_per_i = _ordering_outcomes_sorted(d, c, lf, rf, lf > 0, rf > 0)
    cnt_fail = _segment_count(d, lf, fail_per_i)
    cnt_pass = _segment_count(d, lf, pass_per_i)
    n_lhs_flat = _segment_count(d, lf, d.ones_b())
    any_fail = (cnt_fail > 0) | (lhs_unres > 0) | ((rhs_unres > 0) & (n_lhs_flat > 0))
    if c.match_all:
        st = _where8(any_fail, FAIL, PASS)
    else:
        st = _where8(cnt_pass > 0, PASS, FAIL)
    skip = ((n_lhs + lhs_unres) == 0) | ((n_rhs + rhs_unres) == 0)
    return _where8(skip, SKIP, st)


def _eval_query_rhs_clause(d: _DocArrays, c: CClause, sel, rule_statuses,
                           sel_is_root: bool = False) -> torch.Tensor:
    """Eq / In of an LHS query against an RHS query, per origin:
    query_in set difference (Eq), containment (In), and the reverse-diff
    inversion under `not`. Membership is canonical struct-id equality
    (= loose_eq)."""
    lhs_sel, lhs_unres, rhs_sel, rhs_unres, n_lhs, n_rhs = _query_rhs_sides(
        d, c, sel, rule_statuses, sel_is_root
    )
    lhs_total = n_lhs + lhs_unres
    rhs_total = n_rhs + rhs_unres
    q_success = _query_rhs_success_sorted(
        d, c, lhs_sel, rhs_sel, n_lhs, n_rhs, lhs_total, rhs_total
    )
    # unresolved entries survive the inversion as FAILs; rhs-unresolved
    # entries exist only when some lhs resolved
    entry_fail = (lhs_unres > 0) | ((rhs_unres > 0) & (n_lhs > 0))
    if c.match_all:
        st = _where8(entry_fail | ~q_success, FAIL, PASS)
    else:
        # `some` needs a PASS entry: a vacuous containment with no
        # resolved lhs value FAILs
        st = _where8(q_success & (n_lhs > 0), PASS, FAIL)
    skip = (lhs_total == 0) | (rhs_total == 0)
    return _where8(skip, SKIP, st)


def _query_rhs_success_sorted(d: _DocArrays, c: CClause, lhs_sel, rhs_sel,
                              n_lhs, n_rhs, lhs_total, rhs_total) -> torch.Tensor:
    """(D, N+1) bool per-origin query_in / containment success through
    per-(origin, struct-id) joins. A list LHS value against a
    SUBSET-mode list RHS value is per pair: such documents are flagged
    unsure (the oracle decides them)."""
    sid = d.struct_id
    shared = c.rhs_query_from_root
    lhs_here = lhs_sel > 0
    rhs_here = rhs_sel > 0
    valid_l = lhs_here & (sid >= 0)
    valid_r = rhs_here & (sid >= 0)
    zeros = d.zeros_i(d.n)
    # membership org keys: real origins per side, or one shared key
    l_org = zeros if shared else lhs_sel
    r_org = zeros if shared else rhs_sel

    if c.op == CmpOperator.Eq:
        m_lhs = _in_set_sorted(l_org, sid, valid_l, r_org, sid, valid_r)
        cnt_lhs_not_in = _segment_count(d, lhs_sel, lhs_here & ~m_lhs)
        if shared:
            # rhs values present in origin o's lhs set: the global
            # per-sid rhs count summed over o's DISTINCT lhs sids
            w = _set_count_sorted(zeros, sid, valid_l, zeros, sid, valid_r)
            f = _distinct_first_sorted(lhs_sel, sid, valid_l)
            cnt_rhs_in = _weighted_count(d, f, w, lhs_sel)
            cnt_rhs_not_in = n_rhs - cnt_rhs_in
        else:
            m_rhs = _in_set_sorted(r_org, sid, valid_r, l_org, sid, valid_l)
            cnt_rhs_not_in = _segment_count(d, rhs_sel, rhs_here & ~m_rhs)
        use_lhs_diff = n_lhs > n_rhs
        q_success = torch.where(use_lhs_diff, cnt_lhs_not_in, cnt_rhs_not_in) == 0
        if not c.op_not:
            return q_success
        # the FORWARD diff side is chosen by resolved counts, the REVERSE
        # side independently by total counts (unresolved included)
        use_rhs_rdiff = rhs_total >= lhs_total
        if shared:
            diff_l = valid_l & ~m_lhs
            # over the LHS side: with the lhs-side diff, is the lhs sid
            # among o's diff sids; with the rhs-side diff no lhs sid is
            # outside its own set, so every lhs counts
            m_l_in_dl = _in_set_sorted(lhs_sel, sid, valid_l, lhs_sel, sid, diff_l)
            rdiff_a = torch.where(
                use_lhs_diff, _segment_count(d, lhs_sel, lhs_here & ~m_l_in_dl), n_lhs
            )
            # over the shared RHS side: rhs sids outside o's diff sids,
            # or (rhs-side diff) rhs sids inside o's lhs set
            f_d = _distinct_first_sorted(lhs_sel, sid, diff_l)
            cnt_rhs_in_dl = _weighted_count(d, f_d, w, lhs_sel)
            rdiff_b = torch.where(use_lhs_diff, n_rhs - cnt_rhs_in_dl, cnt_rhs_in)
        else:
            # diff members carry lhs OR rhs labels
            use_l = use_lhs_diff.to(_I32)
            use_l_at_lhs = K.gather_rows(use_l, torch.where(lhs_here, lhs_sel, 0)) > 0
            use_l_at_rhs = K.gather_rows(use_l, torch.where(rhs_here, rhs_sel, 0)) > 0
            diff_l = valid_l & ~m_lhs & use_l_at_lhs
            diff_r = valid_r & ~m_rhs & ~use_l_at_rhs
            set_org = torch.cat(
                [torch.where(diff_l, lhs_sel, 0), torch.where(diff_r, rhs_sel, 0)], dim=1
            )
            set_sid = torch.cat([sid, sid], dim=1)
            set_mask = torch.cat([diff_l, diff_r], dim=1)
            in_diff_l = _in_set_sorted(lhs_sel, sid, valid_l, set_org, set_sid, set_mask)
            in_diff_r = _in_set_sorted(rhs_sel, sid, valid_r, set_org, set_sid, set_mask)
            rdiff_a = _segment_count(d, lhs_sel, lhs_here & ~in_diff_l)
            rdiff_b = _segment_count(d, rhs_sel, rhs_here & ~in_diff_r)
        rdiff_cnt = torch.where(use_rhs_rdiff, rdiff_b, rdiff_a)
        return ~q_success & (rdiff_cnt == 0)

    # In: contained_in per lhs value. Any-kind lhs values match rhs
    # values by sid, scalar/map lhs values also match INSIDE rhs lists;
    # list lhs values match list rhs values only in membership mode (the
    # rhs list's first element is itself a list)
    is_list = d.node_kind == LIST
    first_is_list = _count_children(d, (d.node_index == 0) & is_list) > 0
    membership_mode = first_is_list & (d.child_count > 0)
    # children of rhs-selected lists carry the parent's origin key
    pr_org = K.gather_rows(r_org, d.node_parent.clamp(min=0))
    p_rhs_list = _parent_select(d, (rhs_here & is_list).to(_I32)) > 0
    p_memb = _parent_select(d, (rhs_here & is_list & membership_mode).to(_I32)) > 0
    s_org = torch.cat([r_org, pr_org], dim=1)
    s_sid = torch.cat([sid, sid], dim=1)
    # non-list lhs: rhs values (eq) and children of rhs lists
    m_nonlist = _in_set_sorted(
        l_org, sid, valid_l & ~is_list, s_org, s_sid,
        torch.cat([valid_r, p_rhs_list & (sid >= 0)], dim=1),
    )
    # list lhs: non-list rhs values and children of membership-mode lists
    m_list = _in_set_sorted(
        l_org, sid, valid_l & is_list, s_org, s_sid,
        torch.cat([valid_r & ~is_list, p_memb & (sid >= 0)], dim=1),
    )
    m_lhs = torch.where(is_list, m_list, m_nonlist)
    # subset-mode pairs (list lhs vs non-membership list rhs) are per
    # PAIR: flag the document unsure where one can exist
    a = _segment_count(d, lhs_sel, lhs_here & is_list)
    b_mask = rhs_here & is_list & ~membership_mode
    if shared:
        b = b_mask.any(dim=1)[:, None]
    else:
        b = _segment_count(d, rhs_sel, b_mask) > 0
    d.unsure_acc.append(((a > 0) & b).any(dim=1))

    q_success = _segment_count(d, lhs_sel, lhs_here & ~m_lhs) == 0
    if c.op_not:
        diff_lhs = valid_l & ~m_lhs
        in_diff = _in_set_sorted(lhs_sel, sid, valid_l, lhs_sel, sid, diff_lhs)
        rdiff_cnt = _segment_count(d, lhs_sel, lhs_here & ~in_diff)
        q_success = ~q_success & (rdiff_cnt == 0)
    return q_success


# ---------------------------------------------------------------------------
# clause / block / conjunction evaluation
# ---------------------------------------------------------------------------

_TYPE_OF = {
    CmpOperator.IsString: STRING,
    CmpOperator.IsList: LIST,
    CmpOperator.IsMap: MAP,
    CmpOperator.IsInt: INT,
    CmpOperator.IsFloat: FLOAT,
    CmpOperator.IsBool: BOOL,
    CmpOperator.IsNull: NULL,
}


def eval_clause(d: _DocArrays, c: CClause, sel, rule_statuses=None,
                scalar: bool = False) -> torch.Tensor:
    if c.eval_from_root and not scalar:
        # root-bound variable head inside a value scope: evaluate once
        # from the document root and broadcast to every origin
        st = eval_clause(d, c, _sel_root(d), rule_statuses, scalar=True)
        return d.full8(st, scalar=False)
    if c.rhs_query_steps is not None:
        if c.op in _NOT_ORDER:
            st = _eval_query_rhs_ordering(d, c, sel, rule_statuses, sel_is_root=scalar)
        else:
            st = _eval_query_rhs_clause(d, c, sel, rule_statuses, sel_is_root=scalar)
        # rule-root mode runs per origin from the root: its origin is label 1
        return st[:, 1] if scalar else st
    sel_leaf, n_unres = run_steps(d, c.steps, sel, rule_statuses, scalar=scalar)
    n_res = _agg(d, sel_leaf, d.ones_b(), scalar)
    total = n_res + n_unres

    if c.op.is_unary():
        if c.op == CmpOperator.Empty and c.empty_on_expr:
            is_null = d.node_kind == NULL
            ok_res = ~is_null if c.op_not else is_null
            if c.negation:
                ok_res = ~ok_res
            pass_res = _agg(d, sel_leaf, ok_res, scalar)
            fail_res = n_res - pass_res
            unres_pass = (not c.op_not) != bool(c.negation)
            fail_n = fail_res + (0 if unres_pass else n_unres)
            st = _where8(fail_n > 0, FAIL, PASS)
            empty_result = (not c.op_not) != bool(c.negation)
            return _where8(total == 0, PASS if empty_result else FAIL, st)

        # element-wise unary ops
        kind = d.node_kind
        if c.op == CmpOperator.Exists:
            base = d.ones_b()
            unres_base = False
        elif c.op == CmpOperator.Empty:
            str_is_empty = (kind == STRING) & d.bits[d.empty_slot]
            base = torch.where(
                (kind == LIST) | (kind == MAP), d.child_count == 0, str_is_empty
            )
            unres_base = True
            # elementwise EMPTY on int/float/null raises on the oracle:
            # flag the document unsure
            supported = (
                (kind == STRING) | (kind == LIST) | (kind == MAP) | (kind == BOOL)
            )
            d.unsure_acc.append(((sel_leaf > 0) & ~supported).any(dim=1))
        else:
            base = kind == _TYPE_OF[c.op]
            unres_base = False
        outcome = base
        unres_outcome = unres_base
        if c.op_not:
            outcome = ~outcome
            unres_outcome = not unres_outcome
        if c.negation:
            outcome = ~outcome
            unres_outcome = not unres_outcome
        n_pass = _agg(d, sel_leaf, outcome, scalar) + (
            n_unres if unres_outcome else 0
        )
        n_fail = total - n_pass
        if c.match_all:
            st = _where8(n_fail > 0, FAIL, PASS)
        else:
            st = _where8(n_pass > 0, PASS, FAIL)
        return _where8(total == 0, SKIP, st)

    # binary: UnResolved LHS entries FAIL
    outcome, _active = _eval_binary_outcomes(d, c, sel_leaf)
    if isinstance(outcome, tuple):
        outcome_all, outcome_any = outcome
    else:
        outcome_all = outcome_any = outcome
    if c.match_all:
        n_fail = n_res - _agg(d, sel_leaf, outcome_all, scalar) + n_unres
        st = _where8(n_fail > 0, FAIL, PASS)
    else:
        st = _where8(_agg(d, sel_leaf, outcome_any, scalar) > 0, PASS, FAIL)
    return _where8(total == 0, SKIP, st)


def eval_count_clause(d: _DocArrays, c: CCountClause, rule_statuses,
                      scalar: bool) -> torch.Tensor:
    """`%n <op> rhs` for a count() variable: resolve the argument query
    from the root, count the resolved leaves, compare. One status per
    document, broadcast in node mode."""
    if c.static_status is not None:
        return d.full8(d.const8(c.static_status), scalar)
    sel_leaf, _ = run_steps(d, c.steps, _sel_root(d), rule_statuses, scalar=True)
    cnt = (sel_leaf > 0).sum(dim=1, dtype=_I32)
    never = torch.zeros((d.d,), dtype=torch.bool, device=d.device)
    tag = c.cmp[0]
    if tag == "never":
        ok = never
    elif tag == "int":
        _, v, op, op_not = c.cmp
        if op == CmpOperator.Eq:
            ok = cnt == v
        elif op == CmpOperator.Gt:
            ok = cnt > v
        elif op == CmpOperator.Ge:
            ok = cnt >= v
        elif op == CmpOperator.Lt:
            ok = cnt < v
        else:
            ok = cnt <= v
        if op_not:
            ok = ~ok
    elif tag == "range":
        _, lo, hi, incl, op_not = c.cmp
        lo_ok = cnt >= lo if incl & LOWER_INCLUSIVE else cnt > lo
        hi_ok = cnt <= hi if incl & UPPER_INCLUSIVE else cnt < hi
        ok = lo_ok & hi_ok
        if op_not:
            ok = ~ok
    else:  # "in" list
        _, ints, op_not = c.cmp
        ok = never
        for v in ints:
            ok = ok | (cnt == v)
        if op_not:
            ok = ~ok
    return d.full8(_where8(ok, PASS, FAIL), scalar)


def eval_node(d: _DocArrays, node, sel, rule_statuses, scalar: bool = False) -> torch.Tensor:
    if isinstance(node, CClause):
        return eval_clause(d, node, sel, rule_statuses, scalar=scalar)
    if isinstance(node, CCountClause):
        return eval_count_clause(d, node, rule_statuses, scalar)
    if isinstance(node, CBlockClause):
        return eval_block_clause(d, node, sel, rule_statuses, scalar=scalar)
    if isinstance(node, CWhenBlock):
        block = eval_conjunctions(d, node.inner, sel, rule_statuses, scalar=scalar)
        if node.conditions is None:
            # ungated grouping (inline-expanded parameterized rule body)
            return block
        cond = eval_conjunctions(d, node.conditions, sel, rule_statuses, scalar=scalar)
        return _where8(cond == PASS, block, SKIP)
    if isinstance(node, CNamedRef):
        # first non-SKIP status among same-named rules, file order
        st = rule_statuses[node.rule_indices[0]]
        d.unsure_acc.append(d.rule_unsure[node.rule_indices[0]])
        for idx in node.rule_indices[1:]:
            st = torch.where(st == SKIP, rule_statuses[idx], st)
            # an unsure dependency makes the referencing rule unsure too
            d.unsure_acc.append(d.rule_unsure[idx])
        if node.negation:
            out = _where8(st == PASS, FAIL, PASS)
        else:
            out = _where8(st == PASS, PASS, FAIL)
        return d.full8(out, scalar)
    raise TypeError(f"unknown node {node!r}")


def eval_block_clause(d: _DocArrays, b: CBlockClause, sel, rule_statuses=None,
                      scalar: bool = False):
    leaves, unres = run_steps(d, b.query_steps, sel, rule_statuses, scalar=scalar)
    is_leaf = leaves > 0
    inner_sel = torch.where(is_leaf, d.idx1, 0)
    # inner conjunctions evaluate per leaf: always node mode
    inner_status = eval_conjunctions(d, b.inner, inner_sel, rule_statuses)
    leaf_status = inner_status[:, 1:]
    # regroup by the OUTER origin (labels carried in `leaves`)
    n_pass = _agg(d, leaves, is_leaf & (leaf_status == PASS), scalar)
    n_fail = _agg(d, leaves, is_leaf & (leaf_status == FAIL), scalar) + unres
    total = _agg(d, leaves, is_leaf, scalar) + unres
    if b.match_all:
        st = _where8(n_fail > 0, FAIL, _where8(n_pass > 0, PASS, SKIP))
    else:
        st = _where8(n_pass > 0, PASS, _where8(n_fail > 0, FAIL, SKIP))
    return _where8(total == 0, FAIL if b.not_empty else SKIP, st)


def _any_pass_fail(statuses: List[torch.Tensor]):
    any_pass = statuses[0] == PASS
    any_fail = statuses[0] == FAIL
    for s in statuses[1:]:
        any_pass = any_pass | (s == PASS)
        any_fail = any_fail | (s == FAIL)
    return any_pass, any_fail


def _combine_disjunction(statuses: List[torch.Tensor]) -> torch.Tensor:
    """any PASS -> PASS; else any FAIL -> FAIL; else SKIP."""
    any_pass, any_fail = _any_pass_fail(statuses)
    return _where8(any_pass, PASS, _where8(any_fail, FAIL, SKIP))


def _combine_conjunction(statuses: List[torch.Tensor]) -> torch.Tensor:
    """any FAIL -> FAIL; else any PASS -> PASS; else SKIP."""
    any_pass, any_fail = _any_pass_fail(statuses)
    return _where8(any_fail, FAIL, _where8(any_pass, PASS, SKIP))


def eval_conjunctions(d: _DocArrays, conjunctions, sel, rule_statuses=None,
                      scalar: bool = False):
    return _combine_conjunction([
        _combine_disjunction(
            [eval_node(d, n, sel, rule_statuses, scalar=scalar) for n in disj]
        )
        for disj in conjunctions
    ])


def eval_rule(d: _DocArrays, rule: CRule, rule_statuses) -> Tuple[torch.Tensor, torch.Tensor]:
    """(status (D,), unsure (D,)) of one rule. Rule-level conjunctions
    evaluate in single-origin scalar mode from the document root; only
    filter and block interiors pay for per-origin histograms."""
    mark = len(d.unsure_acc)
    sel_root = _sel_root(d)
    status = eval_conjunctions(d, rule.conjunctions, sel_root, rule_statuses, scalar=True)
    if rule.conditions is not None:
        cond = eval_conjunctions(d, rule.conditions, sel_root, rule_statuses, scalar=True)
        status = _where8(cond == PASS, status, SKIP)
    unsure = torch.zeros((d.d,), dtype=torch.bool, device=d.device)
    for bit in d.unsure_acc[mark:]:
        unsure = unsure | bit
    del d.unsure_acc[mark:]
    return status, unsure


def build_doc_evaluator(compiled: CompiledRules):
    """fn(arrays, lits) -> (statuses (D, R) int8, unsure (D, R) bool)
    over the tensors of `arrays_from_numpy`."""
    empty_slot = compiled.str_empty_slot
    rules = compiled.rules

    def evaluate(arrays: Dict[str, torch.Tensor], lits: torch.Tensor):
        d = _DocArrays(arrays, lits, empty_slot)
        statuses: List[torch.Tensor] = []
        for rule in rules:
            st, u = eval_rule(d, rule, statuses)
            statuses.append(st)
            d.rule_unsure.append(u)
        if not statuses:
            return (
                torch.zeros((d.d, 0), dtype=_I8, device=d.device),
                torch.zeros((d.d, 0), dtype=torch.bool, device=d.device),
            )
        return torch.stack(statuses, dim=1), torch.stack(d.rule_unsure, dim=1)

    return evaluate


def arrays_from_numpy(arrays: Dict[str, np.ndarray], lits: np.ndarray,
                      device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The JAX package's inputs as the port's tensors: the numpy dict
    of CompiledRules.device_arrays(batch) and lit_values() (this system
    has no weights; these columns stand in their place), copied to
    `device` with their dtypes (int32 columns, bool flags)."""
    dev = torch.device(device)
    out = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, non_blocking=True)
        for k, v in arrays.items()
    }
    return out, torch.from_numpy(np.ascontiguousarray(lits, dtype=np.int32)).to(dev)
