"""Host-precomputed function variables (a copy of the JAX package's
ops/fnvars.py; SURVEY.md §7 hard-part 7).

The reference's built-in functions (`guard/src/rules/functions/` —
strings.rs, converters.rs, date_time.rs, collections.rs) are stateful,
string-producing transforms that cannot run on device. Instead of
sending every rule that touches one to the CPU oracle, the device path
PRECOMPUTES each file-level function `let` per document on the host
(via the same oracle resolution the CPU engine uses,
eval_context.rs:1286-1472 dispatch) and encodes the resulting values as
EXTRA ORPHAN SUBTREES in the columnar batch:

  * result nodes are appended after the document's own nodes with
    `node_parent = -1`, so no traversal step can ever reach them —
    they are invisible to `.*`, `[*]`, keys filters and `empty`;
  * each result ROOT is tagged with a reserved negative key id
    (`fn_key_id(slot)` — a namespace that can never collide with
    interned map keys, which are >= 0), and a dedicated `StepFnVar`
    selects exactly those roots;
  * everything downstream — comparisons, regex bit columns, struct
    ids, key walks INTO `json_parse` trees — is ordinary kernel
    machinery, because the results ARE nodes.

Function variables never contain UnResolved entries (resolve_function
drops None results, scopes.py:343-356), so `StepFnVar` charges no
UnResolved accounting. Functions that RAISE on a document (e.g.
`parse_int('abc')`, converters.rs error paths) mark that document
host-only; the oracle rerun then reproduces the reference's error
behavior exactly.

Excluded from precompute (rules touching them fall back to the CPU
oracle):
  * `count`   — lowered natively as an integer compare (ir.CCountClause);
  * `now`     — nondeterministic: precomputing at encode time and
                re-resolving in the oracle rerun could straddle a
                second boundary and diverge;
  * `parse_char` — produces CHAR nodes, which documents otherwise
                never contain; kernel comparability tables assume so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from ..core.errors import GuardError
from ..core.exprs import (
    AccessQuery,
    FunctionExpr,
    RulesFile,
    part_is_variable,
    part_variable,
)
from ..core.qresult import RESOLVED
from ..core.values import CHAR, PV, REGEX

_EXCLUDED = {"count", "now", "parse_char"}

# reserved node_key_id namespace: interned ids are >= 0, list elements
# -1, root/padding -2 — function slots live at -1000 - slot
_FN_KEY_BASE = -1000


def fn_key_id(slot: int) -> int:
    return _FN_KEY_BASE - slot


def _filter_candidates(prev_part, cur: PV):
    """Mirror of scopes._retrieve_filter's candidate derivation
    (eval_context.rs:723-828 / scopes.py:702-770): which values a
    filter's clause CNF evaluates against, given the value reached by
    the query prefix and the part class preceding the filter. Returns
    None where the oracle raises InternalError. The `[*]`-preceded
    outer-scope case never reaches consumption (ir refuses `filter
    after [*]` wholesale, so such rules stay on the host)."""
    from ..core.exprs import QAllIndices, QAllValues, QKey
    from ..core.values import LIST, MAP

    if prev_part is not None and part_is_variable(prev_part):
        # after a variable head, maps AND scalars filter themselves in
        # their own value scope; lists iterate (scopes.py:390-408,
        # ir.StepFilter scalar_self)
        if cur.kind == LIST:
            return list(cur.val)
        return [cur]
    if cur.kind == MAP:
        if isinstance(prev_part, (QAllValues, QAllIndices)):
            return [cur]
        if isinstance(prev_part, QKey) or prev_part is None:
            return list(cur.val.values.values())
        return None
    if cur.kind == LIST:
        return list(cur.val)
    if isinstance(prev_part, QAllIndices):
        return [cur]
    return []


def _pvar_bindable(value, excluded: Set[str]) -> bool:
    """A cross-scope binding precomputes only when nothing in it
    touches the excluded builtins (now/parse_char — nondeterminism /
    CHAR nodes) or a transitively-excluded variable."""
    if isinstance(value, FunctionExpr):
        vars_: Set[str] = set()
        names: Set[str] = set()
        _expr_refs(value, vars_, names)
        return not (names & _EXCLUDED) and not (vars_ & excluded)
    if isinstance(value, AccessQuery):
        return not (_query_vars(value) & excluded)
    return True


def _vs_depth(vs_path: tuple) -> int:
    """Value-scope DEPTH of a path: block / type-block / filter
    entries each open a new scope; when-blocks keep the enclosing
    selection (ir.lower_guard_clause keeps the scope token), so they
    are transparent. Cross-scope = binding depth strictly shallower
    than use depth."""
    return sum(1 for e in vs_path if e[0] != "when")


def _query_vars(q: AccessQuery) -> Set[str]:
    out: Set[str] = set()
    for part in q.query:
        if part_is_variable(part):
            out.add(part_variable(part))
    return out


def _expr_refs(fx: FunctionExpr, acc_vars: Set[str], acc_names: Set[str]) -> None:
    acc_names.add(fx.name)
    for p in fx.parameters:
        if isinstance(p, FunctionExpr):
            _expr_refs(p, acc_vars, acc_names)
        elif isinstance(p, AccessQuery):
            acc_vars.update(_query_vars(p))


def _when_chains(rule):
    """Yield (chain, block) for the rule body and every when-block
    nested through ROOT-BASIS paths only: when-blocks keep the
    enclosing selection (eval.rs:1428-1502), so a when-block reached
    without crossing a value scope still evaluates — and binds its
    `let`s — at the document root. `chain` is the list of enclosing
    Blocks from the rule body down (exclusive of `block`)."""
    from ..core.exprs import WhenBlockClause

    def walk(block, chain):
        yield chain, block
        for disj in block.conjunctions:
            for c in disj:
                if isinstance(c, WhenBlockClause):
                    yield from walk(c.block, chain + [block])

    yield from walk(rule.block, [])


def _fn_lets(rf: RulesFile) -> List[Tuple[int, str, FunctionExpr, list]]:
    """Every function `let` with a root binding basis: file-level
    (rule_idx -1), rule-BODY lets, and lets in when-blocks reached
    without crossing a value scope (rule blocks and their when-blocks
    evaluate with the document root as scope basis,
    eval_context.rs:980-997). Lets inside type blocks / nested
    query blocks are not enumerated (value scopes). The last element
    is the enclosing-Block chain for scope reconstruction (empty for
    file/rule-body lets)."""
    out: List[Tuple[int, str, FunctionExpr, list]] = []
    for let in rf.assignments:
        if isinstance(let.value, FunctionExpr):
            out.append((-1, let.var, let.value, []))
    for ri, rule in enumerate(rf.guard_rules):
        for chain, block in _when_chains(rule):
            for let in block.assignments:
                if isinstance(let.value, FunctionExpr):
                    out.append((ri, let.var, let.value, chain + [block]))
    return out


def _excluded_fn_vars(rf: RulesFile) -> Set[str]:
    """Variable NAMES excluded from precompute because their value
    (transitively, name-level fixpoint over possibly-forward
    references) touches an excluded builtin. Enumerates EVERY let in
    the file — root-basis AND value-scope lets, found by a generic
    structural walk — because a value-scope binding can indirect a
    precomputable slot to parse_char/now just as well as a root one
    (`let a = parse_char(Code)  let t = %a  Props[ K == %t ]`);
    name-level across scopes is a conservative over-approximation
    (same-named safe lets merely fall back to the host)."""
    from ..core.exprs import LetExpr, walk_expr_tree

    lets: List[LetExpr] = []

    def visit(o) -> bool:
        if isinstance(o, LetExpr):
            lets.append(o)
            return True
        return False

    walk_expr_tree(rf, visit)
    info = []
    for let in lets:
        vars_: Set[str] = set()
        names: Set[str] = set()
        if isinstance(let.value, FunctionExpr):
            _expr_refs(let.value, vars_, names)
        elif isinstance(let.value, AccessQuery):
            vars_ = _query_vars(let.value)
        info.append((let.var, vars_, names))
    excluded = {var for var, _, names in info if names & _EXCLUDED}
    changed = True
    while changed:
        changed = False
        for var, vars_, _ in info:
            if var not in excluded and vars_ & excluded:
                excluded.add(var)
                changed = True
    return excluded


def _encodable_literal(pv: PV) -> bool:
    """Only value kinds the document encoder models exactly may become
    synthetic nodes (no REGEX/RANGE/CHAR literals)."""
    k = pv.kind
    if k in (REGEX, CHAR) or k in (9, 10, 11):  # RANGE_*
        return False
    if k == 7:  # LIST
        return all(_encodable_literal(e) for e in pv.val)
    if k == 8:  # MAP
        return all(_encodable_literal(v) for v in pv.val.values.values())
    return True


def _walk_clauses(conjunctions, fn):
    from ..core.exprs import (
        BlockGuardClause,
        GuardAccessClause,
        ParameterizedNamedRuleClause,
        TypeBlock,
        WhenBlockClause,
    )

    for disj in conjunctions or []:
        for c in disj:
            fn(c)
            if isinstance(c, BlockGuardClause):
                _walk_clauses(c.block.conjunctions, fn)
            elif isinstance(c, WhenBlockClause):
                _walk_clauses(c.conditions, fn)
                _walk_clauses(c.block.conjunctions, fn)
            elif isinstance(c, TypeBlock):
                _walk_clauses(c.conditions, fn)
                _walk_clauses(c.block.conjunctions, fn)


def _walk_queries(conjunctions, fn):
    """Call fn(query_parts) for every AccessQuery under the clauses
    (including filters nested inside queries)."""
    from ..core.exprs import (
        BlockGuardClause,
        GuardAccessClause,
        ParameterizedNamedRuleClause,
        QFilter,
        TypeBlock,
    )

    def do_parts(parts):
        fn(parts)
        for part in parts:
            if isinstance(part, QFilter):
                _walk_queries(part.conjunctions, fn)

    def visit(c):
        if isinstance(c, GuardAccessClause):
            do_parts(c.access_clause.query.query)
            if isinstance(c.access_clause.compare_with, AccessQuery):
                do_parts(c.access_clause.compare_with.query)
        elif isinstance(c, ParameterizedNamedRuleClause):
            for p in c.parameters:
                if isinstance(p, AccessQuery):
                    do_parts(p.query)
        elif isinstance(c, BlockGuardClause):
            do_parts(c.query.query)
        elif isinstance(c, TypeBlock):
            do_parts(c.query)  # a plain parts list, not an AccessQuery

    _walk_clauses(conjunctions, visit)


def _head_var_names(rf: RulesFile) -> Set[str]:
    """Variable names used as a query HEAD anywhere in the file."""
    heads: Set[str] = set()

    def on_query(parts):
        if parts and part_is_variable(parts[0]):
            heads.add(part_variable(parts[0]))

    for rule in rf.guard_rules:
        _walk_queries(rule.conditions, on_query)
        _walk_queries(rule.block.conjunctions, on_query)
    for prule in rf.parameterized_rules:
        _walk_queries(prule.rule.conditions, on_query)
        _walk_queries(prule.rule.block.conjunctions, on_query)
    for let in rf.assignments:
        if isinstance(let.value, AccessQuery):
            on_query(let.value.query)
    return heads


@dataclass
class _Slot:
    key: tuple  # opaque encode-order key
    kind: str  # 'fn' | 'lit' | 'expr' | 'pexpr'
    rule_idx: int  # -1 = file scope
    var: str = ""  # fn/lit
    pv: object = None  # lit
    fx: object = None  # expr/pexpr (FunctionExpr)
    # enclosing-Block chain (rule body + nested when-blocks) the
    # precompute folds into a scope stack; empty = file/rule scope
    chain: tuple = ()
    # 'pexpr' only: the value-scope path from the root-basis chain down
    # to the clause — ('block', BlockGuardClause) / ('type', TypeBlock)
    # / ('when', WhenBlockClause) entries the precompute replays to
    # enumerate candidate origins exactly like the oracle
    # (evaluator.eval_guard_block_clause / eval_type_block_clause)
    vs_path: tuple = ()


@dataclass
class FnSlots:
    """Everything the encoder / lowering / precompute agree on."""

    slots: List[_Slot]
    # function lets, keyed by the BINDING's FunctionExpr identity: the
    # let's value object uniquely names the binding, so the same
    # (rule, name) bound in several when blocks disambiguates for free
    # (the lowering resolves the name through its scoped block_vars and
    # looks the winning object up here)
    var_slots: Dict[int, int]  # id(FunctionExpr) -> slot
    lit_slots: Dict[Tuple[int, str], int]  # literal lets used as heads
    expr_slots: Dict[int, int]  # id(FunctionExpr) -> slot (inline uses)
    pv_slots: Dict[int, int]  # id(PV) -> slot (literal call arguments)
    # id(FunctionExpr) -> slot for origin-DEPENDENT inline calls in
    # value scopes: precomputed once per (document, candidate origin),
    # selected per origin label by the kernels (ir.StepFnVar
    # per_origin)
    pexpr_slots: Dict[int, int] = None
    # id(AccessQuery) -> slot for CROSS-SCOPE value-scope variable
    # uses as clause RHS (`Resources.* { let t = Type  Properties[
    # Kind == %t ] exists }`): the variable re-resolves per enclosing
    # origin, so its values precompute once per USE-SITE candidate
    # (resolved through the replayed scope chain, which lands on the
    # binding origin's scope) and join per origin label exactly like
    # pexpr results
    pvar_slots: Dict[int, int] = None

    @property
    def keys(self) -> List[tuple]:
        return [s.key for s in self.slots]


def fn_slots(rf: RulesFile) -> FnSlots:
    """Enumerate every precomputable slot, in deterministic order:

      * function `let`s (file-level and rule-body) — resolved per doc;
      * literal `let`s whose NAME is used as a query head anywhere
        (their value becomes a synthetic subtree so `%lit.x` /
        `%lit == query` walks work) — constant across docs;
      * inline FunctionExpr uses in TOP-LEVEL rule clauses: clause RHS
        (`"a,b" == join(%c, ',')`) and parameterized-call arguments
        (eval.rs:1574-1599 resolves them in the caller's scope) —
        keyed by expression identity, resolved per doc in the owning
        rule's scope.
    """
    excluded = _excluded_fn_vars(rf)
    slots: List[_Slot] = []
    var_slots: Dict[int, int] = {}
    lit_slots: Dict[Tuple[int, str], int] = {}
    expr_slots: Dict[int, int] = {}
    pv_slots: Dict[int, int] = {}
    pexpr_slots: Dict[int, int] = {}
    pvar_slots: Dict[int, int] = {}

    def add(slot: _Slot) -> int:
        slots.append(slot)
        return len(slots) - 1

    # function lets, incl. when-block lets at root basis. A (rule,
    # name) bound in MORE THAN ONE when block gets one slot per
    # binding (the occurrence index keeps encode keys unique); the
    # precompute resolves each through its own block chain, and the
    # lowering disambiguates by the binding's FunctionExpr identity
    fn_lets = [t for t in _fn_lets(rf) if t[1] not in excluded]
    for occ, (ri, var, fx, chain) in enumerate(fn_lets):
        var_slots[id(fx)] = add(
            _Slot(
                key=("fn", ri, var, occ), kind="fn", rule_idx=ri,
                var=var, chain=tuple(chain),
            )
        )

    heads = _head_var_names(rf)
    for let in rf.assignments:
        if (
            isinstance(let.value, PV)
            and let.var in heads
            and _encodable_literal(let.value)
        ):
            lit_slots[(-1, let.var)] = add(
                _Slot(
                    key=("lit", -1, let.var), kind="lit", rule_idx=-1,
                    var=let.var, pv=let.value,
                )
            )
    for ri, rule in enumerate(rf.guard_rules):
        lit_lets = [
            (chain, let)
            for chain, block in _when_chains(rule)
            for let in block.assignments
            if isinstance(let.value, PV)
        ]
        lit_counts: Dict[str, int] = {}
        for _chain, let in lit_lets:
            lit_counts[let.var] = lit_counts.get(let.var, 0) + 1
        for _chain, let in lit_lets:
            if (
                let.var in heads
                and lit_counts[let.var] == 1
                and _encodable_literal(let.value)
            ):
                lit_slots[(ri, let.var)] = add(
                    _Slot(
                        key=("lit", ri, let.var), kind="lit", rule_idx=ri,
                        var=let.var, pv=let.value,
                    )
                )

    def usable_expr(fx: FunctionExpr) -> bool:
        vars_, names = set(), set()
        _expr_refs(fx, vars_, names)
        # count is excluded from LET precompute only because lets have
        # the cheaper native CCountClause path; inline there is none,
        # and its single-int result encodes exactly
        return not (names & (_EXCLUDED - {"count"})) and not (
            vars_ & excluded
        )

    file_let_names = {let.var for let in rf.assignments}

    def _root_safe(fx: FunctionExpr, bound: Set[str], vs_bound: Set[str]) -> bool:
        """Inside a VALUE scope an inline call only precomputes when its
        result is origin-independent: every query parameter must be
        headed by a variable whose binding lives on the root-basis
        chain (file / rule / enclosing when-block lets), with no name
        shadowed by a value-scope binding."""
        vars_, _names = set(), set()
        _expr_refs(fx, vars_, _names)
        if vars_ & vs_bound or not vars_ <= bound:
            return False

        def check(f: FunctionExpr) -> bool:
            for p in f.parameters:
                if isinstance(p, AccessQuery):
                    if not (p.query and part_is_variable(p.query[0])):
                        return False
                elif isinstance(p, FunctionExpr) and not check(p):
                    return False
            return True

        return check(fx)

    from ..core.exprs import (
        BlockGuardClause,
        GuardAccessClause,
        ParameterizedNamedRuleClause,
        QFilter,
        TypeBlock,
        WhenBlockClause,
    )

    for ri, rule in enumerate(rf.guard_rules):

        def bound_names(chain) -> Set[str]:
            names = set(file_let_names)
            for b in chain:
                names.update(let.var for let in b.assignments)
            return names

        def on_expr(fx, chain, in_vs, vs_binds, vs_path=(),
                    lhs_root=False, ri=ri):
            if (
                id(fx) in expr_slots
                or id(fx) in pexpr_slots
                or not usable_expr(fx)
            ):
                return
            if in_vs and not _root_safe(
                fx, bound_names(chain), set(vs_binds)
            ):
                # origin-DEPENDENT inline call: the result genuinely
                # differs per candidate, so it precomputes per origin
                # (kind 'pexpr') — the encoder tags each result subtree
                # with its origin node and the kernels select per
                # origin label (ir.StepFnVar per_origin). The scope
                # path replays block / type-block / when-block entries
                # AND query-filter entries (filter candidates derive
                # from the recorded query prefix exactly like
                # scopes._retrieve_filter). A clause whose LHS
                # evaluates from the ROOT basis (head variable bound on
                # the root chain -> ir raises CrossScopeRootVar and
                # then refuses the per-origin RHS) gets no slot:
                # the lowering could never consume it, so precomputing
                # and encoding its results would be pure waste.
                if lhs_root:
                    return
                pexpr_slots[id(fx)] = add(
                    _Slot(
                        key=("pexpr", ri, len(pexpr_slots)), kind="pexpr",
                        rule_idx=ri, fx=fx, chain=tuple(chain),
                        vs_path=tuple(vs_path),
                    )
                )
                return
            expr_slots[id(fx)] = add(
                _Slot(
                    key=("expr", ri, len(expr_slots)), kind="expr",
                    rule_idx=ri, fx=fx, chain=tuple(chain),
                )
            )

        def walk_parts(parts, chain, vs_binds, vs_path=(), ri=ri):
            for pi, part in enumerate(parts):
                if isinstance(part, QFilter):
                    # record the query prefix: the precompute derives
                    # this filter's candidate set from it
                    vp = vs_path + (("filter", part, tuple(parts[:pi])),)
                    for disj in part.conjunctions:
                        for cc in disj:
                            walk_clause(cc, chain, True, vs_binds, vp)

        def walk_clause(c, chain, in_vs, vs_binds, vs_path=(), ri=ri):
            if isinstance(c, GuardAccessClause):
                cw = c.access_clause.compare_with
                parts = c.access_clause.query.query
                lhs_root = bool(
                    in_vs
                    and parts
                    and part_is_variable(parts[0])
                    and part_variable(parts[0]) not in vs_binds
                    and part_variable(parts[0]) in bound_names(chain)
                )
                if isinstance(cw, FunctionExpr):
                    # mirror of ir's CrossScopeRootVar: a head variable
                    # bound on the root chain (and not shadowed in the
                    # value scope) re-roots the LHS at the document
                    # root, which the per-origin RHS then refuses
                    on_expr(cw, chain, in_vs, vs_binds, vs_path, lhs_root)
                elif (
                    isinstance(cw, AccessQuery)
                    and in_vs
                    and not lhs_root
                    and len(cw.query) == 1
                    and part_is_variable(cw.query[0])
                    and id(cw) not in pvar_slots
                ):
                    # cross-scope value-scope variable as clause RHS:
                    # bound in an ENCLOSING value scope (strictly
                    # shallower than this clause — same-depth uses
                    # lower natively), so it re-resolves per origin.
                    # Precomputed per use-site candidate ('pvar').
                    # LITERAL bindings are origin-independent and
                    # already lower through ir.lower_rhs — no slot.
                    var = part_variable(cw.query[0])
                    bind = vs_binds.get(var)
                    if (
                        bind is not None
                        and bind[0] < _vs_depth(vs_path)
                        and not isinstance(bind[1], PV)
                        and _pvar_bindable(bind[1], excluded)
                    ):
                        pvar_slots[id(cw)] = add(
                            _Slot(
                                key=("pvar", ri, len(pvar_slots)),
                                kind="pvar", rule_idx=ri, var=var,
                                chain=tuple(chain),
                                vs_path=tuple(vs_path),
                            )
                        )
                walk_parts(parts, chain, vs_binds, vs_path)
                if isinstance(cw, AccessQuery):
                    walk_parts(cw.query, chain, vs_binds, vs_path)
            elif isinstance(c, ParameterizedNamedRuleClause):
                for p in c.parameters:
                    if isinstance(p, FunctionExpr):
                        # rule-call args lower at root scope only
                        # (ir.lower_parameterized_call)
                        if not in_vs:
                            on_expr(p, chain, in_vs, vs_binds)
                    elif isinstance(p, PV):
                        # literal call argument: the callee may use the
                        # parameter as a query head
                        if (
                            not in_vs
                            and id(p) not in pv_slots
                            and _encodable_literal(p)
                        ):
                            pv_slots[id(p)] = add(
                                _Slot(
                                    key=("plit", ri, len(pv_slots)),
                                    kind="lit", rule_idx=ri, pv=p,
                                )
                            )
                    elif isinstance(p, AccessQuery):
                        walk_parts(p.query, chain, vs_binds, vs_path)
            elif isinstance(c, WhenBlockClause):
                for disj in c.conditions or []:
                    for cc in disj:
                        walk_clause(cc, chain, in_vs, vs_binds, vs_path)
                if in_vs:
                    vp = vs_path + (("when", c),)
                    # when-blocks keep the enclosing selection, so
                    # their lets bind at the ENCLOSING depth
                    vb = dict(vs_binds)
                    for let in c.block.assignments:
                        vb[let.var] = (_vs_depth(vs_path), let.value)
                    for disj in c.block.conjunctions:
                        for cc in disj:
                            walk_clause(cc, chain, True, vb, vp)
                else:
                    ch = chain + (c.block,)
                    for disj in c.block.conjunctions:
                        for cc in disj:
                            walk_clause(cc, ch, False, vs_binds)
            elif isinstance(c, (BlockGuardClause, TypeBlock)):
                if isinstance(c, BlockGuardClause):
                    walk_parts(c.query.query, chain, vs_binds, vs_path)
                    vp = vs_path + (("block", c),)
                else:
                    walk_parts(c.query, chain, vs_binds, vs_path)
                    for disj in c.conditions or []:
                        for cc in disj:
                            walk_clause(cc, chain, in_vs, vs_binds, vs_path)
                    vp = vs_path + (("type", c),)
                vb = dict(vs_binds)
                for let in c.block.assignments:
                    vb[let.var] = (_vs_depth(vp), let.value)
                for disj in c.block.conjunctions:
                    for cc in disj:
                        walk_clause(cc, chain, True, vb, vp)

        base_chain = (rule.block,)
        for disj in rule.conditions or []:
            for c in disj:
                walk_clause(c, base_chain, False, {})
        for disj in rule.block.conjunctions:
            for c in disj:
                walk_clause(c, base_chain, False, {})

    return FnSlots(
        slots=slots, var_slots=var_slots, lit_slots=lit_slots,
        expr_slots=expr_slots, pv_slots=pv_slots,
        pexpr_slots=pexpr_slots, pvar_slots=pvar_slots,
    )


def precomputable_fn_vars(rf: RulesFile) -> List[tuple]:
    """Slot keys in encode order (empty = nothing to precompute)."""
    return fn_slots(rf).keys


def precompute_fn_values(
    rf: RulesFile, docs: List[PV]
) -> Tuple[List[tuple], List[Dict[tuple, List[PV]]], Set[int]]:
    """(slot keys in encode order, per-doc {slot key: [result PVs]},
    error doc indices).

    Resolution goes through the same RootScope/BlockScope machinery
    the CPU engine uses, so chained lets (`let b = to_upper(%a)`),
    references to file- and rule-level query lets, and literal/query
    arguments behave identically. A document on which any function
    raises lands in the error set — the caller routes it to the CPU
    oracle, which reproduces the error through the normal path. (The
    precompute is eager, so a document whose erroring rule would have
    been when-gated to SKIP still lands in the error set — it then
    merely evaluates on the oracle, with identical statuses.)"""
    layout = fn_slots(rf)
    keys = layout.keys
    values: List[Dict[tuple, List[PV]]] = []
    errors: Set[int] = set()
    if not layout.slots:
        return keys, [{} for _ in docs], errors
    from ..core.scopes import (  # lazy
        BlockScope,
        RootScope,
        ValueScope,
        resolve_function,
    )

    def _pexpr_scopes(slot, base_scope, cache):
        """[(origin PV, resolver)] replaying the slot's value-scope
        path with the SAME scope shapes the oracle builds: each
        block/type-block level resolves its query in the current scope
        and wraps every RESOLVED value in ValueScope + BlockScope
        (evaluator.eval_guard_block_clause:1126 /
        eval_type_block_clause:1424 -> eval_general_block_clause:1071);
        when-blocks keep the origin and add their lets. Origins are
        reached by strictly-descending traversal, so each innermost
        origin has exactly one scope chain. Query-FILTER entries
        derive their candidate sets from the recorded query prefix,
        mirroring scopes._retrieve_filter branch for branch. `cache`
        memoizes the pairs per (base scope, vs_path) within one
        document: k calls in the same scope replay its queries and
        when-gates once, not k times."""
        ckey = (id(base_scope),) + tuple(id(e[1]) for e in slot.vs_path)
        hit = cache.get(ckey)
        if hit is not None:
            return hit
        from ..core.evaluator import (  # lazy (cycle via scopes)
            eval_conjunction_clauses,
            eval_when_clause,
        )
        from ..core.qresult import Status

        def when_passes(conditions, sc) -> bool:
            """eval.rs:1428-1502 gate: only PASSing conditions enter
            the block — origins behind a false/skipped guard are NOT
            precomputed, so a guard protecting a call from bad input
            (`when Limit == /^[0-9]+$/ { ... parse_int(Limit) ... }`)
            keeps its documents on the device path instead of flagging
            spurious fn errors. A RAISE during condition evaluation
            propagates: the caller flags the doc and the oracle
            reproduces the error."""
            if not conditions:
                return True
            return (
                eval_conjunction_clauses(
                    conditions, sc, eval_when_clause,
                    context=(
                        "cfn_guard::rules::exprs::WhenGuardClause"
                        "#disjunction"
                    ),
                )
                == Status.PASS
            )

        pairs = [(None, base_scope)]
        for entry in slot.vs_path:
            kind, node = entry[0], entry[1]
            if kind == "when":
                pairs = [
                    (o, BlockScope(node.block, sc.root(), sc))
                    for o, sc in pairs
                    if when_passes(node.conditions, sc)
                ]
                continue
            if kind == "filter":
                # candidates per scopes._retrieve_filter: resolve the
                # recorded query prefix in the current scope, then
                # expand per the part class preceding the filter
                prefix = list(entry[2])
                prev_part = prefix[-1] if prefix else None
                new = []
                for _o, sc in pairs:
                    if prefix:
                        curs = [
                            qr.value
                            for qr in sc.query(prefix)
                            if qr.tag == RESOLVED
                        ]
                    else:
                        curs = [sc.root()]
                    for cur in curs:
                        cands = _filter_candidates(prev_part, cur)
                        if cands is None:
                            # the oracle raises InternalError for
                            # filters after such parts — route the
                            # doc there
                            from ..core.errors import InternalError

                            raise InternalError(
                                "filter after unexpected query part"
                            )
                        for cand in cands:
                            new.append((cand, ValueScope(cand, sc)))
                pairs = new
                continue
            q = node.query.query if kind == "block" else node.query
            new = []
            for _o, sc in pairs:
                if kind == "type" and not when_passes(
                    getattr(node, "conditions", None), sc
                ):
                    # type-block conditions gate at the OUTER scope
                    # (eval_type_block_clause) — a non-PASS gate means
                    # no origins at all
                    continue
                for qr in sc.query(q):
                    if qr.tag != RESOLVED:
                        continue
                    vs = ValueScope(qr.value, sc)
                    new.append(
                        (qr.value, BlockScope(node.block, vs.root(), vs))
                    )
            pairs = new
        cache[ckey] = pairs
        return pairs

    for i, doc in enumerate(docs):
        per: Dict[tuple, List[PV]] = {}
        root = RootScope(rf, doc)
        chain_scopes: Dict[tuple, BlockScope] = {}
        pexpr_cache: Dict[tuple, list] = {}

        def scope_for(chain):
            """Fold the slot's enclosing-Block chain (rule body +
            nested when-blocks, all root-basis) into a scope stack so
            chained lets and shadowing resolve like the oracle's."""
            if not chain:
                return root
            key = tuple(id(b) for b in chain)
            s = chain_scopes.get(key)
            if s is None:
                s = BlockScope(chain[-1], doc, scope_for(chain[:-1]))
                chain_scopes[key] = s
            return s

        try:
            for slot in layout.slots:
                if slot.kind == "lit":
                    per[slot.key] = [slot.pv]
                elif slot.kind == "fn":
                    per[slot.key] = [
                        q.value
                        for q in scope_for(slot.chain).resolve_variable(
                            slot.var
                        )
                        if q.tag == RESOLVED
                    ]
                elif slot.kind == "pexpr":
                    # origin-dependent inline call: one result list per
                    # candidate origin, keyed by the origin node's path
                    # (unique per node; the encoder maps it back to the
                    # node index for the fn_origin column)
                    per_origin: Dict[str, List[PV]] = {}
                    for origin, sc in _pexpr_scopes(
                        slot, scope_for(slot.chain), pexpr_cache
                    ):
                        opath = origin.path.s
                        if opath in per_origin:
                            continue
                        per_origin[opath] = [
                            q.value
                            for q in resolve_function(
                                slot.fx.name, slot.fx.parameters, sc
                            )
                            if q.tag == RESOLVED
                        ]
                    per[slot.key] = per_origin
                elif slot.kind == "pvar":
                    # cross-scope value-scope variable as clause RHS:
                    # resolve the variable through each use-site
                    # candidate's replayed scope chain (which lands on
                    # the binding origin's scope, with shadowing and
                    # single-shot caching exactly like the oracle's).
                    # UnResolved entries would need per-origin
                    # UnResolved accounting the kernels don't model —
                    # such documents route to the oracle instead.
                    per_origin = {}
                    for origin, sc in _pexpr_scopes(
                        slot, scope_for(slot.chain), pexpr_cache
                    ):
                        opath = origin.path.s
                        if opath in per_origin:
                            continue
                        rs = sc.resolve_variable(slot.var)
                        if any(q.tag != RESOLVED for q in rs):
                            raise GuardError(
                                "cross-scope variable resolves "
                                "UnResolved entries; host evaluation"
                            )
                        per_origin[opath] = [q.value for q in rs]
                    per[slot.key] = per_origin
                else:  # inline expression
                    per[slot.key] = [
                        q.value
                        for q in resolve_function(
                            slot.fx.name,
                            slot.fx.parameters,
                            scope_for(slot.chain),
                        )
                        if q.tag == RESOLVED
                    ]
        except GuardError:
            errors.add(i)
            per = {}
        values.append(per)
    return keys, values, errors
