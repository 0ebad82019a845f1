"""The evaluation engine: CNF clause evaluation with PASS/FAIL/SKIP.

Python equivalent of `guard/src/rules/eval.rs` and
`guard/src/rules/eval/operators.rs`:

  * unary operations incl. the `empty`-on-query special case
    (eval.rs:174-405);
  * binary LHS x RHS comparison with literal/query flattening, QueryIn /
    ListIn semantics and the `not` inversion pass (operators.rs:100-787);
  * clause -> block -> rule -> file evaluation with `some`/`match_all`,
    when-condition SKIP gating, named-rule references and parameterized
    rule calls (eval.rs:1078-2065).

UnResolved query results FAIL the owning clause (with a retained reason)
rather than aborting evaluation — the semantics the device backend encodes
as a tri-state status lattice.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from .errors import GuardError, IncompatibleError, NotComparableError
from .exprs import (
    AccessQuery,
    Block,
    BlockGuardClause,
    CmpOperator,
    FunctionExpr,
    GuardAccessClause,
    GuardNamedRuleClause,
    ParameterizedNamedRuleClause,
    Rule,
    RulesFile,
    TypeBlock,
    WhenBlockClause,
    display_query,
    part_is_variable,
)
from .qresult import LITERAL, RESOLVED, UNRESOLVED, QueryResult, Status, UnResolved
from .records import (
    BlockCheck,
    ClauseCheck,
    ComparisonClauseCheck,
    EventRecord,
    InComparisonCheck,
    MissingValueCheck,
    NamedStatus,
    RecordType,
    TypeBlockCheck,
    UnaryValueCheck,
    ValueCheck,
)
from .scopes import BlockScope, ValueScope, resolve_function
from .values import (
    BOOL,
    LIST,
    MAP,
    STRING,
    PV,
    compare_eq,
    compare_ge,
    compare_gt,
    compare_le,
    compare_lt,
    loose_eq,
)

# ---------------------------------------------------------------------------
# Unary operations (eval.rs:10-92)
# ---------------------------------------------------------------------------
def _exists_op(qr: QueryResult) -> bool:
    return qr.tag != UNRESOLVED


def _element_empty_op(qr: QueryResult) -> bool:
    if qr.tag == UNRESOLVED:
        return True  # !EXISTS == EMPTY (eval.rs:33-36)
    v = qr.value
    if v.kind == LIST:
        return len(v.val) == 0
    if v.kind == MAP:
        return v.val.is_empty()
    if v.kind == STRING:
        return len(v.val) == 0
    if v.kind == BOOL:
        return False  # bool -> to_string never empty (eval.rs:23)
    raise IncompatibleError(
        f"Attempting EMPTY operation on type {v.type_info()} that does not "
        f"support it at {v.self_path().s}"
    )


def _is_kind_op(kind: int):
    def op(qr: QueryResult) -> bool:
        return qr.tag != UNRESOLVED and qr.value.kind == kind

    return op


from .values import CHAR, FLOAT, INT, NULL  # noqa: E402

_UNARY_OPS = {
    CmpOperator.Exists: _exists_op,
    CmpOperator.Empty: _element_empty_op,
    CmpOperator.IsString: _is_kind_op(STRING),
    CmpOperator.IsList: _is_kind_op(LIST),
    CmpOperator.IsMap: _is_kind_op(MAP),
    CmpOperator.IsInt: _is_kind_op(INT),
    CmpOperator.IsFloat: _is_kind_op(FLOAT),
    CmpOperator.IsBool: _is_kind_op(BOOL),
    CmpOperator.IsNull: _is_kind_op(NULL),
}

# sentinel for the EmptyQueryResult evaluation outcome (eval.rs:168-171)
class EmptyQueryResult:
    __slots__ = ("status",)

    def __init__(self, status: Status):
        self.status = status


def unary_operation(
    lhs_query: List,
    cmp: Tuple[CmpOperator, bool],
    inverse: bool,
    context: str,
    custom_message: Optional[str],
    eval_context,
):
    """eval.rs:174-405."""
    lhs = eval_context.query(lhs_query)
    op, op_not = cmp

    last = lhs_query[-1]
    from .exprs import QFilter, QMapKeyFilter  # local to avoid cycle clutter

    empty_on_expr = isinstance(last, (QFilter, QMapKeyFilter)) or (
        part_is_variable(last) and len(lhs_query) == 1
    )

    if empty_on_expr and op == CmpOperator.Empty:
        # eval.rs:198-298 — EMPTY over a projection/variable: resolved
        # entries are non-empty (unless null), unresolved ones are empty
        if lhs:
            results = []
            for each in lhs:
                eval_context.start_record(context)
                if each.tag != UNRESOLVED:
                    ok = (not each.value.is_null()) if op_not else each.value.is_null()
                    qr = QueryResult.resolved(each.value)
                    status = Status.PASS if ok else Status.FAIL
                else:
                    qr = each
                    status = Status.FAIL if op_not else Status.PASS
                if inverse:
                    status = Status.PASS if status == Status.FAIL else Status.FAIL
                if status == Status.PASS:
                    eval_context.end_record(
                        context,
                        RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success()),
                    )
                else:
                    eval_context.end_record(
                        context,
                        RecordType(
                            RecordType.CLAUSE_VALUE_CHECK,
                            ClauseCheck.unary(
                                UnaryValueCheck(
                                    value=ValueCheck(
                                        from_=qr,
                                        status=Status.FAIL,
                                        custom_message=custom_message,
                                    ),
                                    comparison=cmp,
                                )
                            ),
                        ),
                    )
                results.append((qr, status))
            return results
        result = not op_not
        if inverse:
            result = not result
        eval_context.start_record(context)
        if result:
            eval_context.end_record(
                context, RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success())
            )
            return EmptyQueryResult(Status.PASS)
        eval_context.end_record(
            context,
            RecordType(
                RecordType.CLAUSE_VALUE_CHECK,
                ClauseCheck.no_value_for_empty(custom_message),
            ),
        )
        return EmptyQueryResult(Status.FAIL)

    if not lhs:
        # only happens when the query has filters (eval.rs:300-305)
        return EmptyQueryResult(Status.SKIP)

    base_op = _UNARY_OPS[op]

    def operation(qr: QueryResult) -> bool:
        r = base_op(qr)
        if op_not:
            r = not r
        if inverse:
            r = not r
        return r

    results = []
    for each in lhs:
        eval_context.start_record(context)
        try:
            ok = operation(each)
        except GuardError as e:
            eval_context.end_record(
                context,
                RecordType(
                    RecordType.CLAUSE_VALUE_CHECK,
                    ClauseCheck.unary(
                        UnaryValueCheck(
                            value=ValueCheck(
                                from_=each,
                                status=Status.FAIL,
                                message=str(e),
                                custom_message=custom_message,
                            ),
                            comparison=cmp,
                        )
                    ),
                ),
            )
            raise
        if ok:
            eval_context.end_record(
                context, RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success())
            )
            results.append((each, Status.PASS))
        else:
            eval_context.end_record(
                context,
                RecordType(
                    RecordType.CLAUSE_VALUE_CHECK,
                    ClauseCheck.unary(
                        UnaryValueCheck(
                            value=ValueCheck(
                                from_=each,
                                status=Status.FAIL,
                                custom_message=custom_message,
                            ),
                            comparison=cmp,
                        )
                    ),
                ),
            )
            results.append((each, Status.FAIL))
    return results


# ---------------------------------------------------------------------------
# operators.rs — ValueEvalResult as tagged tuples:
#   ("lhs_unresolved", UnResolved)
#   ("rhs_unresolved", UnResolved, lhs_pv)
#   ("not_comparable", reason, lhs_pv, rhs_pv)
#   ("success"|"fail", compare) where compare is:
#       ("value", lhs, rhs) | ("value_in", lhs, rhs)
#       | ("list_in", diff, lhs, rhs) | ("query_in", diff, lhs_list, rhs_list)
# ---------------------------------------------------------------------------
def _selected(query_results, on_unresolved, flatten_lists=False):
    """selected()/flattened() (operators.rs:116-144)."""
    out: List[PV] = []
    for each in query_results:
        if each.tag == UNRESOLVED:
            on_unresolved(each.unresolved)
        elif flatten_lists and each.value.kind == LIST:
            out.extend(each.value.val)
        else:
            out.append(each.value)
    return out


def _match_value(lhs: PV, rhs: PV, comparator) -> tuple:
    """operators.rs:178-207."""
    try:
        ok = comparator(lhs, rhs)
    except NotComparableError as e:
        return ("not_comparable", str(e), lhs, rhs)
    return ("success", ("value", lhs, rhs)) if ok else ("fail", ("value", lhs, rhs))


def _is_literal(query_results) -> Optional[PV]:
    """operators.rs:209-216."""
    if len(query_results) == 1 and query_results[0].tag == LITERAL:
        return query_results[0].value
    return None


def _string_in(lhs: PV, rhs: PV) -> tuple:
    """operators.rs:218-230 — substring containment."""
    if lhs.kind == STRING and rhs.kind == STRING:
        ok = lhs.val in rhs.val
        return ("success", ("value", lhs, rhs)) if ok else ("fail", ("value", lhs, rhs))
    return (
        "not_comparable",
        f"Type not comparable, {lhs.type_info()}, {rhs.type_info()}",
        lhs,
        rhs,
    )


def _contained_in(lhs: PV, rhs: PV) -> tuple:
    """operators.rs:256-321."""
    if lhs.kind == LIST:
        if rhs.kind == LIST:
            rhsl = rhs.val
            if rhsl and rhsl[0].kind == LIST:
                # list-of-lists membership
                if any(loose_eq(lhs, e) for e in rhsl):
                    return ("success", ("list_in", [], lhs, rhs))
                return ("fail", ("list_in", [lhs], lhs, rhs))
            diff = [e for e in lhs.val if not any(loose_eq(e, r) for r in rhsl)]
            tag = "success" if not diff else "fail"
            return (tag, ("list_in", diff, lhs, rhs))
        return (
            "not_comparable",
            f"Can not compare type {lhs.type_info()}, {rhs.type_info()}",
            lhs,
            rhs,
        )
    if rhs.kind == LIST:
        if any(loose_eq(lhs, e) for e in rhs.val):
            return ("success", ("value_in", lhs, rhs))
        return ("fail", ("value_in", lhs, rhs))
    return _match_value(lhs, rhs, compare_eq)


def _eq_operation(lhs_results, rhs_results) -> List[tuple]:
    """EqOperation (operators.rs:453-598)."""
    results: List[tuple] = []
    l_lit = _is_literal(lhs_results)
    r_lit = _is_literal(rhs_results)

    if l_lit is not None and r_lit is not None:
        results.append(_match_value(l_lit, r_lit, compare_eq))
        return results

    if l_lit is not None:
        rhs = _selected(
            rhs_results,
            lambda ur: results.append(("rhs_unresolved", ur, l_lit)),
        )
        if l_lit.kind == LIST:
            for each in rhs:
                results.append(_match_value(l_lit, each, compare_eq))
        else:
            for each_r in rhs:
                if each_r.kind == LIST:
                    for inner in each_r.val:
                        results.append(_match_value(l_lit, inner, compare_eq))
                else:
                    results.append(_match_value(l_lit, each_r, compare_eq))
        return results

    if r_lit is not None:
        lhs_flat = _selected(
            lhs_results, lambda ur: results.append(("lhs_unresolved", ur))
        )
        if r_lit.kind == LIST:
            for each in lhs_flat:
                if each.is_scalar() and len(r_lit.val) == 1:
                    results.append(_match_value(each, r_lit.val[0], compare_eq))
                else:
                    results.append(_match_value(each, r_lit, compare_eq))
        else:
            for each in lhs_flat:
                if each.kind == LIST:
                    for inner in each.val:
                        results.append(_match_value(inner, r_lit, compare_eq))
                else:
                    results.append(_match_value(each, r_lit, compare_eq))
        return results

    # query vs query: set-difference semantics (operators.rs:552-594)
    lhs_sel = _selected(lhs_results, lambda ur: results.append(("lhs_unresolved", ur)))
    rhs_sel = _selected(
        rhs_results,
        lambda ur: results.extend(
            ("rhs_unresolved", ur, l) for l in lhs_sel
        ),
    )
    if len(lhs_sel) > len(rhs_sel):
        diff = [e for e in lhs_sel if not any(loose_eq(e, r) for r in rhs_sel)]
    else:
        diff = [e for e in rhs_sel if not any(loose_eq(e, l) for l in lhs_sel)]
    tag = "success" if not diff else "fail"
    results.append((tag, ("query_in", diff, lhs_sel, rhs_sel)))
    return results


def _in_operation(lhs_results, rhs_results) -> List[tuple]:
    """InOperation (operators.rs:323-451)."""
    results: List[tuple] = []
    l_lit = _is_literal(lhs_results)
    r_lit = _is_literal(rhs_results)

    if l_lit is not None and r_lit is not None:
        first = _string_in(l_lit, r_lit)
        if first[0] == "success":
            results.append(first)
        else:
            results.append(_contained_in(l_lit, r_lit))
        return results

    if l_lit is not None:
        rhs = _selected(
            rhs_results, lambda ur: results.append(("rhs_unresolved", ur, l_lit))
        )
        if any(e.kind == LIST for e in rhs):
            for r in rhs:
                results.append(_contained_in(l_lit, r))
        elif l_lit.kind == LIST:
            diff = [e for e in l_lit.val if not any(loose_eq(e, r) for r in rhs)]
            tag = "success" if not diff else "fail"
            results.append((tag, ("query_in", diff, [l_lit], rhs)))
        else:
            for r in rhs:
                results.append(_contained_in(l_lit, r))
        return results

    if r_lit is not None:
        lhs_sel = _selected(
            lhs_results, lambda ur: results.append(("lhs_unresolved", ur))
        )
        for l in lhs_sel:
            if r_lit.kind == STRING:
                if l.kind == LIST:
                    for inner in l.val:
                        results.append(_string_in(inner, r_lit))
                else:
                    results.append(_string_in(l, r_lit))
            else:
                results.append(_contained_in(l, r_lit))
        return results

    lhs_sel = _selected(lhs_results, lambda ur: results.append(("lhs_unresolved", ur)))
    rhs_sel = _selected(
        rhs_results,
        lambda ur: results.extend(("rhs_unresolved", ur, l) for l in lhs_sel),
    )
    diff = []
    for l in lhs_sel:
        if not any(_contained_in(l, r)[0] == "success" for r in rhs_sel):
            diff.append(l)
    tag = "success" if not diff else "fail"
    results.append((tag, ("query_in", diff, lhs_sel, rhs_sel)))
    return results


def _common_operation(lhs_results, rhs_results, comparator) -> List[tuple]:
    """CommonOperator for < <= > >= (operators.rs:146-176): flattens
    list values on both sides, full cartesian comparison."""
    results: List[tuple] = []
    lhs_flat = _selected(
        lhs_results, lambda ur: results.append(("lhs_unresolved", ur)),
        flatten_lists=True,
    )
    rhs_flat = _selected(
        rhs_results,
        lambda ur: results.extend(("rhs_unresolved", ur, l) for l in lhs_flat),
        flatten_lists=True,
    )
    for l in lhs_flat:
        for r in rhs_flat:
            results.append(_match_value(l, r, comparator))
    return results


_COMMON_CMP = {
    CmpOperator.Lt: compare_lt,
    CmpOperator.Gt: compare_gt,
    CmpOperator.Le: compare_le,
    CmpOperator.Ge: compare_ge,
}


def _reverse_diff(diff: List[PV], other: List[PV]) -> List[PV]:
    """operators.rs:637-646."""
    return [e for e in other if not any(loose_eq(e, d) for d in diff)]


def operator_compare(cmp: Tuple[CmpOperator, bool], lhs, rhs):
    """(CmpOperator, bool)::compare (operators.rs:600-787).

    Returns None for Skip, else a list of ValueEvalResult tuples with the
    `not` inversion applied.
    """
    op, negated = cmp
    if not lhs or not rhs:
        return None  # EvalResult::Skip (operators.rs:606-608)

    if op == CmpOperator.Eq:
        results = _eq_operation(lhs, rhs)
    elif op == CmpOperator.In:
        results = _in_operation(lhs, rhs)
    elif op in _COMMON_CMP:
        results = _common_operation(lhs, rhs, _COMMON_CMP[op])
    else:
        raise IncompatibleError(f"Operation {op} NOT PERMITTED")

    if not negated:
        return results

    inverted: List[tuple] = []
    for e in results:
        tag = e[0]
        if tag == "fail":
            compare = e[1]
            ckind = compare[0]
            if ckind == "query_in":
                _, diff, lhs_list, rhs_list = compare
                if len(rhs) >= len(lhs) and op == CmpOperator.Eq:
                    rdiff = _reverse_diff(diff, rhs_list)
                else:
                    rdiff = _reverse_diff(diff, lhs_list)
                new_tag = "success" if not rdiff else "fail"
                inverted.append((new_tag, ("query_in", rdiff, lhs_list, rhs_list)))
            elif ckind == "list_in":
                _, diff, l, r = compare
                rdiff = [e2 for e2 in l.val if not any(loose_eq(e2, d) for d in diff)]
                new_tag = "success" if not rdiff else "fail"
                inverted.append((new_tag, ("list_in", rdiff, l, r)))
            else:
                inverted.append(("success", compare))
        elif tag == "success":
            compare = e[1]
            ckind = compare[0]
            if ckind == "query_in":
                _, diff, lhs_list, rhs_list = compare
                inverted.append(("fail", ("query_in", list(lhs_list), lhs_list, rhs_list)))
            elif ckind == "list_in":
                _, diff, l, r = compare
                inverted.append(("fail", ("list_in", list(l.val), l, r)))
            else:
                inverted.append(("fail", compare))
        else:
            inverted.append(e)
    return inverted


# ---------------------------------------------------------------------------
# binary operation record emission (eval.rs:765-974)
# ---------------------------------------------------------------------------
def binary_operation(
    lhs_query: List,
    rhs: List[QueryResult],
    cmp: Tuple[CmpOperator, bool],
    context: str,
    custom_message: Optional[str],
    eval_context,
):
    lhs = eval_context.query(lhs_query)
    results = operator_compare(cmp, lhs, rhs)
    if results is None:
        return EmptyQueryResult(Status.SKIP)

    statuses: List[Tuple[QueryResult, Status]] = []

    def record_fail(check: ClauseCheck, qr: QueryResult):
        eval_context.start_record(context)
        eval_context.end_record(context, RecordType(RecordType.CLAUSE_VALUE_CHECK, check))
        statuses.append((qr, Status.FAIL))

    def record_pass(qr: QueryResult):
        eval_context.start_record(context)
        eval_context.end_record(
            context, RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success())
        )
        statuses.append((qr, Status.PASS))

    for each in results:
        tag = each[0]
        if tag == "lhs_unresolved":
            ur = each[1]
            record_fail(
                ClauseCheck.comparison(
                    ComparisonClauseCheck(
                        status=Status.FAIL,
                        custom_message=custom_message,
                        comparison=cmp,
                        from_=QueryResult.unresolved_(ur),
                        to=None,
                    )
                ),
                QueryResult.unresolved_(ur),
            )
        elif tag == "rhs_unresolved":
            ur, lhs_pv = each[1], each[2]
            record_fail(
                ClauseCheck.comparison(
                    ComparisonClauseCheck(
                        status=Status.FAIL,
                        custom_message=custom_message,
                        comparison=cmp,
                        from_=QueryResult.resolved(lhs_pv),
                        to=QueryResult.unresolved_(ur),
                    )
                ),
                QueryResult.resolved(lhs_pv),
            )
        elif tag == "not_comparable":
            reason, lhs_pv, rhs_pv = each[1], each[2], each[3]
            record_fail(
                ClauseCheck.comparison(
                    ComparisonClauseCheck(
                        status=Status.FAIL,
                        message=reason,
                        custom_message=custom_message,
                        comparison=cmp,
                        from_=QueryResult.resolved(lhs_pv),
                        to=QueryResult.resolved(rhs_pv),
                    )
                ),
                QueryResult.resolved(lhs_pv),
            )
        elif tag == "success":
            compare = each[1]
            ckind = compare[0]
            if ckind == "query_in":
                for l in compare[2]:
                    record_pass(QueryResult.resolved(l))
            else:
                record_pass(QueryResult.resolved(compare[1] if ckind != "list_in" else compare[2]))
        elif tag == "fail":
            compare = each[1]
            ckind = compare[0]
            if ckind == "value":
                _, l, r = compare
                record_fail(
                    ClauseCheck.comparison(
                        ComparisonClauseCheck(
                            status=Status.FAIL,
                            custom_message=custom_message,
                            comparison=cmp,
                            from_=QueryResult.resolved(l),
                            to=QueryResult.resolved(r),
                        )
                    ),
                    QueryResult.resolved(l),
                )
            elif ckind == "value_in":
                _, l, r = compare
                record_fail(
                    ClauseCheck.in_comparison(
                        InComparisonCheck(
                            status=Status.FAIL,
                            custom_message=custom_message,
                            comparison=cmp,
                            from_=QueryResult.resolved(l),
                            to=[QueryResult.resolved(r)],
                        )
                    ),
                    QueryResult.resolved(l),
                )
            elif ckind == "list_in":
                _, diff, l, r = compare
                record_fail(
                    ClauseCheck.in_comparison(
                        InComparisonCheck(
                            status=Status.FAIL,
                            custom_message=custom_message,
                            comparison=cmp,
                            from_=QueryResult.resolved(l),
                            to=[QueryResult.resolved(r)],
                        )
                    ),
                    QueryResult.resolved(l),
                )
            else:  # query_in
                _, diff, lhs_list, rhs_list = compare
                rhs_qrs = [QueryResult.resolved(r) for r in rhs_list]
                for l in diff:
                    record_fail(
                        ClauseCheck.in_comparison(
                            InComparisonCheck(
                                status=Status.FAIL,
                                custom_message=custom_message,
                                comparison=cmp,
                                from_=QueryResult.resolved(l),
                                to=list(rhs_qrs),
                            )
                        ),
                        QueryResult.resolved(l),
                    )
    return statuses


# ---------------------------------------------------------------------------
# real_binary_operation (eval.rs:976-1075) — per-LHS-element comparison
# used by map-key filters
# ---------------------------------------------------------------------------
def _in_cmp(not_in: bool):
    """eval.rs:560-583."""

    def cmp(lhs: PV, rhs: PV) -> bool:
        if lhs.kind == STRING and rhs.kind == STRING:
            result = lhs.val in rhs.val
            return (not result) if not_in else result
        if rhs.kind == LIST:
            found = any(compare_eq(lhs, e) for e in rhs.val)
            return (not found) if not_in else found
        result = compare_eq(lhs, rhs)
        return (not result) if not_in else result

    return cmp


def _not_compare(base, invert: bool):
    def cmp(l: PV, r: PV) -> bool:
        v = base(l, r)
        return (not v) if invert else v

    return cmp


def _each_lhs_compare(cmp_fn, lhs: PV, rhs: List[QueryResult]) -> List[tuple]:
    """eval.rs:434-558."""
    statuses: List[tuple] = []
    for each_rhs in rhs:
        if each_rhs.tag == UNRESOLVED:
            statuses.append(("rhs_unresolved", each_rhs, lhs))
            continue
        rv = each_rhs.value
        try:
            outcome = cmp_fn(lhs, rv)
            statuses.append(
                ("comparable", outcome, lhs, rv)
            )
        except NotComparableError as reason:
            if lhs.kind == LIST:
                handled = True
                for inner in lhs.val:
                    try:
                        outcome = cmp_fn(inner, rv)
                        statuses.append(("comparable", outcome, inner, rv))
                    except NotComparableError as inner_reason:
                        statuses.append(("not_comparable", str(inner_reason), inner, rv))
                continue
            if lhs.is_scalar() and each_rhs.tag == LITERAL and rv.kind == LIST and len(rv.val) == 1:
                inner_rhs = rv.val[0]
                try:
                    outcome = cmp_fn(lhs, inner_rhs)
                    statuses.append(("comparable", outcome, lhs, inner_rhs))
                except NotComparableError as inner_reason:
                    statuses.append(("not_comparable", str(inner_reason), lhs, inner_rhs))
                continue
            statuses.append(("not_comparable", str(reason), lhs, rv))
    return statuses


def real_binary_operation(
    lhs: List[QueryResult],
    rhs: List[QueryResult],
    cmp: Tuple[CmpOperator, bool],
    context: str,
    custom_message: Optional[str],
    eval_context,
) -> List[Tuple[QueryResult, Status]]:
    statuses: List[Tuple[QueryResult, Status]] = []
    op, negated = cmp
    if op == CmpOperator.Eq and len(rhs) > 1:
        op = CmpOperator.In  # eval.rs:986-990

    for each in lhs:
        if each.tag == UNRESOLVED:
            eval_context.start_record(context)
            eval_context.end_record(
                context,
                RecordType(
                    RecordType.CLAUSE_VALUE_CHECK,
                    ClauseCheck.comparison(
                        ComparisonClauseCheck(
                            status=Status.FAIL,
                            custom_message=custom_message,
                            comparison=(op, negated),
                            from_=each,
                            to=None,
                        )
                    ),
                ),
            )
            statuses.append((each, Status.FAIL))
            continue

        l = each.value
        if op == CmpOperator.Eq:
            r = _each_lhs_compare(_not_compare(compare_eq, negated), l, rhs)
        elif op == CmpOperator.Ge:
            r = _each_lhs_compare(_not_compare(compare_ge, negated), l, rhs)
        elif op == CmpOperator.Gt:
            r = _each_lhs_compare(_not_compare(compare_gt, negated), l, rhs)
        elif op == CmpOperator.Lt:
            r = _each_lhs_compare(_not_compare(compare_lt, negated), l, rhs)
        elif op == CmpOperator.Le:
            r = _each_lhs_compare(_not_compare(compare_le, negated), l, rhs)
        elif op == CmpOperator.In:
            r = _each_lhs_compare(_in_cmp(negated), l, rhs)
        else:
            raise IncompatibleError(f"Operation {op} NOT PERMITTED")

        if op == CmpOperator.In:
            statuses.extend(
                _report_at_least_one(r, (op, negated), context, custom_message, eval_context)
            )
        else:
            statuses.extend(
                _report_all_values(r, (op, negated), context, custom_message, eval_context)
            )
    return statuses


def _report_all_values(comparisons, cmp, context, custom_message, eval_context):
    """eval.rs:653-671 + report_value (eval.rs:585-651)."""
    out: List[Tuple[QueryResult, Status]] = []
    for each in comparisons:
        tag = each[0]
        if tag == "comparable":
            _, outcome, l, r = each
            lhs_qr = QueryResult.resolved(l)
            rhs_qr = QueryResult.resolved(r)
        elif tag == "not_comparable":
            _, reason, l, r = each
            outcome = False
            lhs_qr = QueryResult.resolved(l)
            rhs_qr = QueryResult.resolved(r)
        else:  # rhs_unresolved
            _, rhs_q, l = each
            outcome = False
            lhs_qr = QueryResult.resolved(l)
            rhs_qr = rhs_q
        eval_context.start_record(context)
        if outcome:
            eval_context.end_record(
                context, RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success())
            )
            out.append((lhs_qr, Status.PASS))
        else:
            eval_context.end_record(
                context,
                RecordType(
                    RecordType.CLAUSE_VALUE_CHECK,
                    ClauseCheck.comparison(
                        ComparisonClauseCheck(
                            from_=lhs_qr,
                            comparison=cmp,
                            to=rhs_qr,
                            custom_message=custom_message,
                            status=Status.FAIL,
                        )
                    ),
                ),
            )
            out.append((lhs_qr, Status.FAIL))
    return out


def _report_at_least_one(comparisons, cmp, context, custom_message, eval_context):
    """eval.rs:673-753 — group by LHS; PASS if any rhs matched."""
    out: List[Tuple[QueryResult, Status]] = []
    by_lhs: List[Tuple[PV, List[tuple]]] = []

    def entry_for(l: PV) -> List[tuple]:
        for existing, bucket in by_lhs:
            if existing is l:
                return bucket
        bucket: List[tuple] = []
        by_lhs.append((l, bucket))
        return bucket

    for each in comparisons:
        tag = each[0]
        if tag == "comparable":
            entry_for(each[2]).append((each, QueryResult.resolved(each[3])))
        elif tag == "not_comparable":
            entry_for(each[2]).append((each, QueryResult.resolved(each[3])))
        else:  # rhs_unresolved
            entry_for(each[2]).append((each, each[1]))

    for l, bucket in by_lhs:
        found = any(
            e[0] == "comparable" and e[1] for (e, _rhs) in bucket
        )
        eval_context.start_record(context)
        if found:
            eval_context.end_record(
                context, RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success())
            )
            out.append((QueryResult.resolved(l), Status.PASS))
        else:
            to_collected = [rhs for (_e, rhs) in bucket]
            eval_context.end_record(
                context,
                RecordType(
                    RecordType.CLAUSE_VALUE_CHECK,
                    ClauseCheck.in_comparison(
                        InComparisonCheck(
                            from_=QueryResult.resolved(l),
                            to=to_collected,
                            custom_message=custom_message,
                            status=Status.FAIL,
                            comparison=cmp,
                        )
                    ),
                ),
            )
            out.append((QueryResult.resolved(l), Status.FAIL))
    return out


# ---------------------------------------------------------------------------
# Clause evaluation (eval.rs:1078-1225)
# ---------------------------------------------------------------------------
def eval_guard_access_clause(gac: GuardAccessClause, resolver) -> Status:
    all_match = gac.access_clause.query.match_all
    display = gac.display()
    blk_context = f"GuardAccessClause#block{display}"
    resolver.start_record(blk_context)

    cmp = (gac.access_clause.comparator, gac.access_clause.comparator_inverse)
    try:
        if gac.access_clause.comparator.is_unary():
            statuses = unary_operation(
                gac.access_clause.query.query,
                cmp,
                gac.negation,
                display,
                gac.access_clause.custom_message,
                resolver,
            )
        else:
            cw = gac.access_clause.compare_with
            if cw is None:
                resolver.end_record(
                    blk_context,
                    RecordType(
                        RecordType.GUARD_CLAUSE_BLOCK_CHECK,
                        BlockCheck(
                            status=Status.FAIL,
                            at_least_one_matches=not all_match,
                            message="Error not RHS for binary clause when handling clause, bailing",
                        ),
                    ),
                )
                raise NotComparableError(
                    f"GuardAccessClause {blk_context}, did not have a RHS for compare operation"
                )
            if isinstance(cw, PV):
                rhs = [QueryResult.literal(cw)]
            elif isinstance(cw, AccessQuery):
                rhs = resolver.query(cw.query)
            elif isinstance(cw, FunctionExpr):
                rhs = resolve_function(cw.name, cw.parameters, resolver)
            else:
                raise IncompatibleError(f"Unexpected RHS {cw!r}")
            statuses = binary_operation(
                gac.access_clause.query.query,
                rhs,
                cmp,
                display,
                gac.access_clause.custom_message,
                resolver,
            )
    except GuardError as e:
        resolver.end_record(
            blk_context,
            RecordType(
                RecordType.GUARD_CLAUSE_BLOCK_CHECK,
                BlockCheck(
                    status=Status.FAIL,
                    at_least_one_matches=not all_match,
                    message=f"Error {e} when handling clause, bailing",
                ),
            ),
        )
        raise

    if isinstance(statuses, EmptyQueryResult):
        status = statuses.status
        resolver.end_record(
            blk_context,
            RecordType(
                RecordType.GUARD_CLAUSE_BLOCK_CHECK,
                BlockCheck(status=status, at_least_one_matches=all_match, message=None),
            ),
        )
        return status

    fails = sum(1 for (_v, s) in statuses if s == Status.FAIL)
    passes = sum(1 for (_v, s) in statuses if s == Status.PASS)
    if all_match:
        outcome = Status.FAIL if fails > 0 else Status.PASS
    else:
        outcome = Status.PASS if passes > 0 else Status.FAIL
    resolver.end_record(
        blk_context,
        RecordType(
            RecordType.GUARD_CLAUSE_BLOCK_CHECK,
            BlockCheck(status=outcome, at_least_one_matches=not all_match, message=None),
        ),
    )
    return outcome


def eval_guard_named_clause(gnc: GuardNamedRuleClause, resolver) -> Status:
    """eval.rs:1227-1289."""
    context = gnc.display()
    resolver.start_record(context)
    try:
        status = resolver.rule_status(gnc.dependent_rule)
    except GuardError as e:
        resolver.end_record(
            context,
            RecordType(
                RecordType.CLAUSE_VALUE_CHECK,
                ClauseCheck.dependent_rule(
                    MissingValueCheck(
                        rule=gnc.dependent_rule,
                        status=Status.FAIL,
                        message=f"{context} failed due to error {e}",
                        custom_message=gnc.custom_message,
                    )
                ),
            ),
        )
        raise
    if status == Status.PASS:
        outcome = Status.FAIL if gnc.negation else Status.PASS
    else:
        outcome = Status.PASS if gnc.negation else Status.FAIL
    if outcome == Status.PASS:
        resolver.end_record(
            context, RecordType(RecordType.CLAUSE_VALUE_CHECK, ClauseCheck.success())
        )
    else:
        resolver.end_record(
            context,
            RecordType(
                RecordType.CLAUSE_VALUE_CHECK,
                ClauseCheck.dependent_rule(
                    MissingValueCheck(
                        rule=gnc.dependent_rule,
                        status=Status.FAIL,
                        custom_message=gnc.custom_message,
                    )
                ),
            ),
        )
    return outcome


def eval_general_block_clause(
    block: Block,
    resolver,
    eval_fn,
    context: str = "cfn_guard::rules::exprs::GuardClause#disjunction",
) -> Status:
    """eval.rs:1291-1301."""
    scope = BlockScope(block, resolver.root(), resolver)
    return eval_conjunction_clauses(block.conjunctions, scope, eval_fn, context)


def eval_guard_block_clause(block_clause: BlockGuardClause, resolver) -> Status:
    """eval.rs:1303-1426."""
    context = f"BlockGuardClause#{block_clause.location}"
    match_all = block_clause.query.match_all
    resolver.start_record(context)
    try:
        block_values = resolver.query(block_clause.query.query)
    except GuardError:
        resolver.end_record(
            context,
            RecordType(
                RecordType.BLOCK_GUARD_CHECK,
                BlockCheck(status=Status.FAIL, at_least_one_matches=not match_all),
            ),
        )
        raise
    if not block_values:
        status = Status.FAIL if block_clause.not_empty else Status.SKIP
        resolver.end_record(
            context,
            RecordType(
                RecordType.BLOCK_GUARD_CHECK,
                BlockCheck(status=status, at_least_one_matches=not match_all),
            ),
        )
        return status

    fails = passes = 0
    for each in block_values:
        if each.tag == UNRESOLVED:
            fails += 1
            ur = each.unresolved
            guard_cxt = f"GuardBlockAccessClause#{block_clause.location}"
            resolver.start_record(guard_cxt)
            resolver.end_record(
                guard_cxt,
                RecordType(
                    RecordType.CLAUSE_VALUE_CHECK,
                    ClauseCheck.missing_block_value(
                        ValueCheck(
                            from_=each,
                            status=Status.FAIL,
                            message=(
                                f"Query {display_query(block_clause.query.query)} did not "
                                f"resolve to correct value, reason {ur.reason or ''}"
                            ),
                        )
                    ),
                ),
            )
            continue
        val_resolver = ValueScope(each.value, resolver)
        try:
            status = eval_general_block_clause(
                block_clause.block, val_resolver, eval_guard_clause
            )
        except GuardError as e:
            resolver.end_record(
                context,
                RecordType(
                    RecordType.BLOCK_GUARD_CHECK,
                    BlockCheck(
                        status=Status.FAIL,
                        at_least_one_matches=not match_all,
                        message=f"Error {e} when handling block clause, bailing",
                    ),
                ),
            )
            raise
        if status == Status.PASS:
            passes += 1
        elif status == Status.FAIL:
            fails += 1

    if match_all:
        status = (
            Status.FAIL if fails > 0 else Status.PASS if passes > 0 else Status.SKIP
        )
    else:
        status = (
            Status.PASS if passes > 0 else Status.FAIL if fails > 0 else Status.SKIP
        )
    resolver.end_record(
        context,
        RecordType(
            RecordType.BLOCK_GUARD_CHECK,
            BlockCheck(status=status, at_least_one_matches=not match_all),
        ),
    )
    return status


def eval_when_condition_block(context: str, conditions, block: Block, resolver) -> Status:
    """eval.rs:1428-1502."""
    resolver.start_record(context)
    when_context = f"{context}/When"
    resolver.start_record(when_context)
    try:
        status = eval_conjunction_clauses(
            conditions, resolver, eval_when_clause, context="cfn_guard::rules::exprs::WhenGuardClause#disjunction"
        )
    except GuardError as e:
        resolver.end_record(when_context, RecordType(RecordType.WHEN_CONDITION, Status.FAIL))
        resolver.end_record(
            context,
            RecordType(
                RecordType.WHEN_CHECK,
                BlockCheck(
                    status=Status.FAIL,
                    at_least_one_matches=False,
                    message=f"Error {e} during type condition evaluation, bailing",
                ),
            ),
        )
        raise
    if status != Status.PASS:
        resolver.end_record(when_context, RecordType(RecordType.WHEN_CONDITION, status))
        resolver.end_record(
            context,
            RecordType(
                RecordType.WHEN_CHECK,
                BlockCheck(status=Status.SKIP, at_least_one_matches=False),
            ),
        )
        return Status.SKIP
    resolver.end_record(when_context, RecordType(RecordType.WHEN_CONDITION, Status.PASS))

    try:
        status = eval_general_block_clause(block, resolver, eval_guard_clause)
    except GuardError as e:
        resolver.end_record(
            context,
            RecordType(
                RecordType.WHEN_CHECK,
                BlockCheck(
                    status=Status.FAIL,
                    at_least_one_matches=False,
                    message=f"Error {e} during type condition evaluation, bailing",
                ),
            ),
        )
        raise
    resolver.end_record(
        context,
        RecordType(RecordType.WHEN_CHECK, BlockCheck(status=status, at_least_one_matches=False)),
    )
    return status


class _ResolvedParameterContext:
    """eval.rs:1504-1572 — overlays resolved call parameters over the
    parent scope and rewrites the called rule's RuleCheck message."""

    def __init__(self, call_rule: ParameterizedNamedRuleClause, resolved_parameters, parent):
        self.call_rule = call_rule
        self.resolved_parameters = resolved_parameters
        self.parent = parent

    def query(self, query):
        return self.parent.query(query)

    def find_parameterized_rule(self, rule_name):
        return self.parent.find_parameterized_rule(rule_name)

    def root(self):
        return self.parent.root()

    def rule_status(self, rule_name):
        return self.parent.rule_status(rule_name)

    def resolve_variable(self, variable_name):
        if variable_name in self.resolved_parameters:
            return list(self.resolved_parameters[variable_name])
        return self.parent.resolve_variable(variable_name)

    def add_variable_capture_key(self, variable_name, key):
        self.parent.add_variable_capture_key(variable_name, key)

    def start_record(self, context):
        self.parent.start_record(context)

    def end_record(self, context, record: RecordType):
        if (
            record.kind == RecordType.RULE_CHECK
            and record.payload.name == self.call_rule.named_rule.dependent_rule
        ):
            record = RecordType(
                RecordType.RULE_CHECK,
                NamedStatus(
                    name=record.payload.name,
                    status=record.payload.status,
                    message=self.call_rule.named_rule.custom_message,
                ),
            )
        self.parent.end_record(context, record)


def eval_parameterized_rule_call(call_rule: ParameterizedNamedRuleClause, resolver) -> Status:
    """eval.rs:1574-1618."""
    param_rule = resolver.find_parameterized_rule(call_rule.named_rule.dependent_rule)
    if len(param_rule.parameter_names) != len(call_rule.parameters):
        raise IncompatibleError(
            f"Arity mismatch for called parameter rule "
            f"{call_rule.named_rule.dependent_rule}, expected "
            f"{len(param_rule.parameter_names)}, got {len(call_rule.parameters)}"
        )
    resolved = {}
    for idx, each in enumerate(call_rule.parameters):
        name = param_rule.parameter_names[idx]
        if isinstance(each, PV):
            resolved[name] = [QueryResult.resolved(each)]
        elif isinstance(each, AccessQuery):
            resolved[name] = resolver.query(each.query)
        elif isinstance(each, FunctionExpr):
            resolved[name] = resolve_function(each.name, each.parameters, resolver)
        else:
            raise IncompatibleError(f"Unexpected parameter {each!r}")
    ctx = _ResolvedParameterContext(call_rule, resolved, resolver)
    return eval_rule(param_rule.rule, ctx)


def eval_guard_clause(gc, resolver) -> Status:
    """eval.rs:1620-1636."""
    if isinstance(gc, GuardAccessClause):
        return eval_guard_access_clause(gc, resolver)
    if isinstance(gc, GuardNamedRuleClause):
        return eval_guard_named_clause(gc, resolver)
    if isinstance(gc, BlockGuardClause):
        return eval_guard_block_clause(gc, resolver)
    if isinstance(gc, WhenBlockClause):
        return eval_when_condition_block(
            "GuardConditionClause", gc.conditions, gc.block, resolver
        )
    if isinstance(gc, ParameterizedNamedRuleClause):
        return eval_parameterized_rule_call(gc, resolver)
    raise IncompatibleError(f"Unknown guard clause {gc!r}")


def eval_when_clause(wc, resolver) -> Status:
    """eval.rs:1638-1647."""
    if isinstance(wc, GuardAccessClause):
        return eval_guard_access_clause(wc, resolver)
    if isinstance(wc, GuardNamedRuleClause):
        return eval_guard_named_clause(wc, resolver)
    if isinstance(wc, ParameterizedNamedRuleClause):
        return eval_parameterized_rule_call(wc, resolver)
    raise IncompatibleError(f"Unknown when clause {wc!r}")


def eval_type_block_clause(type_block: TypeBlock, resolver) -> Status:
    """eval.rs:1649-1822."""
    context = f"TypeBlock#{type_block.type_name}"
    resolver.start_record(context)
    block = type_block.block
    if type_block.conditions is not None:
        when_context = f"TypeBlock#{type_block.type_name}/When"
        resolver.start_record(when_context)
        try:
            status = eval_conjunction_clauses(
                type_block.conditions,
                resolver,
                eval_when_clause,
                context="cfn_guard::rules::exprs::WhenGuardClause#disjunction",
            )
        except GuardError as e:
            resolver.end_record(
                when_context, RecordType(RecordType.TYPE_CONDITION, Status.FAIL)
            )
            resolver.end_record(
                context,
                RecordType(
                    RecordType.TYPE_CHECK,
                    TypeBlockCheck(
                        type_name=type_block.type_name,
                        block=BlockCheck(
                            status=Status.FAIL,
                            at_least_one_matches=False,
                            message=f"Error {e} during type condition evaluation, bailing",
                        ),
                    ),
                ),
            )
            raise
        if status != Status.PASS:
            resolver.end_record(when_context, RecordType(RecordType.TYPE_CONDITION, status))
            resolver.end_record(
                context,
                RecordType(
                    RecordType.TYPE_CHECK,
                    TypeBlockCheck(
                        type_name=type_block.type_name,
                        block=BlockCheck(status=Status.SKIP, at_least_one_matches=False),
                    ),
                ),
            )
            return Status.SKIP
        resolver.end_record(when_context, RecordType(RecordType.TYPE_CONDITION, Status.PASS))

    try:
        values = resolver.query(type_block.query)
    except GuardError:
        resolver.end_record(
            context,
            RecordType(
                RecordType.TYPE_CHECK,
                TypeBlockCheck(
                    type_name=type_block.type_name,
                    block=BlockCheck(status=Status.FAIL, at_least_one_matches=False),
                ),
            ),
        )
        raise
    if not values:
        resolver.end_record(
            context,
            RecordType(
                RecordType.TYPE_CHECK,
                TypeBlockCheck(
                    type_name=type_block.type_name,
                    block=BlockCheck(status=Status.SKIP, at_least_one_matches=False),
                ),
            ),
        )
        return Status.SKIP

    fails = passes = 0
    for idx, each in enumerate(values):
        if each.tag == UNRESOLVED:
            resolver.end_record(
                context,
                RecordType(
                    RecordType.TYPE_CHECK,
                    TypeBlockCheck(
                        type_name=type_block.type_name,
                        block=BlockCheck(
                            status=Status.FAIL,
                            at_least_one_matches=False,
                            message=each.unresolved.reason,
                        ),
                    ),
                ),
            )
            from .errors import MissingValueError

            raise MissingValueError(
                f"Unable to resolve type block query: {type_block.type_name}"
            )
        block_context = f"{context}/{idx}"
        resolver.start_record(block_context)
        val_resolver = ValueScope(each.value, resolver)
        try:
            status = eval_general_block_clause(block, val_resolver, eval_guard_clause)
        except GuardError as e:
            resolver.end_record(block_context, RecordType(RecordType.TYPE_BLOCK, Status.FAIL))
            resolver.end_record(
                context,
                RecordType(
                    RecordType.TYPE_CHECK,
                    TypeBlockCheck(
                        type_name=type_block.type_name,
                        block=BlockCheck(
                            status=Status.FAIL,
                            at_least_one_matches=False,
                            message=f"Error {e} during type block evaluation, bailing",
                        ),
                    ),
                ),
            )
            raise
        resolver.end_record(block_context, RecordType(RecordType.TYPE_BLOCK, status))
        if status == Status.PASS:
            passes += 1
        elif status == Status.FAIL:
            fails += 1

    status = Status.FAIL if fails > 0 else Status.PASS if passes > 0 else Status.SKIP
    resolver.end_record(
        context,
        RecordType(
            RecordType.TYPE_CHECK,
            TypeBlockCheck(
                type_name=type_block.type_name,
                block=BlockCheck(status=status, at_least_one_matches=False),
            ),
        ),
    )
    return status


def eval_rule_clause(rule_clause, resolver) -> Status:
    """eval.rs:1824-1835."""
    if isinstance(rule_clause, TypeBlock):
        return eval_type_block_clause(rule_clause, resolver)
    if isinstance(rule_clause, WhenBlockClause):
        return eval_when_condition_block(
            "RuleClause", rule_clause.conditions, rule_clause.block, resolver
        )
    return eval_guard_clause(rule_clause, resolver)


def eval_rule(rule: Rule, resolver) -> Status:
    """eval.rs:1837-1906."""
    context = rule.rule_name
    resolver.start_record(context)
    if rule.conditions is not None:
        when_context = f"Rule#{context}/When"
        resolver.start_record(when_context)
        try:
            status = eval_conjunction_clauses(
                rule.conditions,
                resolver,
                eval_when_clause,
                context="cfn_guard::rules::exprs::WhenGuardClause#disjunction",
            )
        except GuardError:
            resolver.end_record(when_context, RecordType(RecordType.RULE_CONDITION, Status.FAIL))
            resolver.end_record(
                context,
                RecordType(
                    RecordType.RULE_CHECK,
                    NamedStatus(name=rule.rule_name, status=Status.FAIL),
                ),
            )
            raise
        if status != Status.PASS:
            resolver.end_record(when_context, RecordType(RecordType.RULE_CONDITION, status))
            resolver.end_record(
                context,
                RecordType(
                    RecordType.RULE_CHECK,
                    NamedStatus(name=rule.rule_name, status=Status.SKIP),
                ),
            )
            return Status.SKIP
        resolver.end_record(when_context, RecordType(RecordType.RULE_CONDITION, Status.PASS))

    try:
        status = eval_general_block_clause(
            rule.block,
            resolver,
            eval_rule_clause,
            context="cfn_guard::rules::exprs::RuleClause#disjunction",
        )
    except GuardError:
        resolver.end_record(
            context,
            RecordType(
                RecordType.RULE_CHECK, NamedStatus(name=rule.rule_name, status=Status.FAIL)
            ),
        )
        raise
    resolver.end_record(
        context,
        RecordType(RecordType.RULE_CHECK, NamedStatus(name=rule.rule_name, status=status)),
    )
    return status


def eval_rules_file(
    rules_file: RulesFile, resolver, data_file_name: Optional[str] = None
) -> Status:
    """eval.rs:1915-1968."""
    context = f"File(rules={len(rules_file.guard_rules)})"
    resolver.start_record(context)
    fails = passes = 0
    for each_rule in rules_file.guard_rules:
        try:
            status = eval_rule(each_rule, resolver)
        except GuardError:
            resolver.end_record(
                context,
                RecordType(
                    RecordType.RULE_CHECK,
                    NamedStatus(name=each_rule.rule_name, status=Status.FAIL),
                ),
            )
            raise
        if status == Status.PASS:
            passes += 1
        elif status == Status.FAIL:
            fails += 1
    overall = Status.FAIL if fails > 0 else Status.PASS if passes > 0 else Status.SKIP
    resolver.end_record(
        context,
        RecordType(
            RecordType.FILE_CHECK,
            NamedStatus(name=data_file_name or "", status=overall),
        ),
    )
    return overall


def eval_conjunction_clauses(
    conjunctions,
    resolver,
    eval_fn,
    context: str = "cfn_guard::rules::exprs::GuardClause#disjunction",
) -> Status:
    """eval.rs:1971-2065 — AND over conjunctions, OR within each;
    SKIPs don't count either way. The context embeds the reference's
    generic type name (eval.rs:1982 uses std::any::type_name::<T>()),
    which reporters pin byte-for-byte."""
    num_passes = num_fails = 0
    for conjunction in conjunctions:
        num_of_disjunction_fails = 0
        multiple_ors = len(conjunction) > 1
        if multiple_ors:
            resolver.start_record(context)
        passed = False
        for disjunction in conjunction:
            try:
                status = eval_fn(disjunction, resolver)
            except GuardError as e:
                if multiple_ors:
                    resolver.end_record(
                        context,
                        RecordType(
                            RecordType.DISJUNCTION,
                            BlockCheck(
                                status=Status.FAIL,
                                at_least_one_matches=True,
                                message=f"Disjunction failed due to error {e}, bailing",
                            ),
                        ),
                    )
                raise
            if status == Status.PASS:
                num_passes += 1
                if multiple_ors:
                    resolver.end_record(
                        context,
                        RecordType(
                            RecordType.DISJUNCTION,
                            BlockCheck(status=Status.PASS, at_least_one_matches=True),
                        ),
                    )
                passed = True
                break
            if status == Status.FAIL:
                num_of_disjunction_fails += 1
        if passed:
            continue
        if num_of_disjunction_fails > 0:
            num_fails += 1
        if multiple_ors:
            resolver.end_record(
                context,
                RecordType(
                    RecordType.DISJUNCTION,
                    BlockCheck(
                        status=Status.FAIL if num_of_disjunction_fails > 0 else Status.SKIP,
                        at_least_one_matches=True,
                    ),
                ),
            )
    if num_fails > 0:
        return Status.FAIL
    if num_passes > 0:
        return Status.PASS
    return Status.SKIP
