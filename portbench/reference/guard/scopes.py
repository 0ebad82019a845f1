"""Scopes, variable resolution and the query tree-walk (the hot loop).

Python equivalent of `guard/src/rules/eval_context.rs`:
`RootScope`/`BlockScope`/`ValueScope` (eval_context.rs:47-87),
`extract_variables` (eval_context.rs:95-117), the recursive
`query_retrieval_with_converter` (eval_context.rs:337-924),
`RecordTracker` (eval_context.rs:999-1059), and `resolve_function`
(eval_context.rs:2437-2472).

Filters inside queries recursively evaluate guard clauses, so this module
and `evaluator.py` are mutually recursive; the evaluator is imported
lazily where needed.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

from .errors import IncompatibleError, InternalError, MissingValueError, NotComparableError
from .exprs import (
    AccessQuery,
    Block,
    FunctionExpr,
    LetExpr,
    ParameterizedRule,
    QAllIndices,
    QAllValues,
    QFilter,
    QIndex,
    QKey,
    QMapKeyFilter,
    QThis,
    Rule,
    RulesFile,
    display_query,
    part_is_variable,
    part_variable,
)
from .functions import call_function
from .qresult import LITERAL, RESOLVED, UNRESOLVED, QueryResult, Status, UnResolved
from .records import EventRecord, RecordType
from .values import LIST, MAP, STRING, PV, rust_debug_pv
from .converters import CONVERTERS


# ---------------------------------------------------------------------------
# Record tracker (eval_context.rs:999-1059)
# ---------------------------------------------------------------------------
class RecordTracker:
    def __init__(self):
        self.events: List[EventRecord] = []
        self.final_event: Optional[EventRecord] = None

    def start_record(self, context: str) -> None:
        self.events.append(EventRecord(context=context))

    def end_record(self, context: str, record: RecordType) -> None:
        if not self.events:
            raise InternalError(
                f"Event Record end with context {context} did not have a corresponding start"
            )
        event = self.events.pop()
        if event.context != context:
            raise InternalError(
                f"Event Record context start and end does not match {context}"
            )
        event.container = record
        if self.events:
            self.events[-1].children.append(event)
        else:
            self.final_event = event

    def extract(self) -> EventRecord:
        ev = self.final_event
        self.final_event = None
        return ev


# ---------------------------------------------------------------------------
# Scope machinery
# ---------------------------------------------------------------------------
def extract_variables(assignments: List[LetExpr]):
    """eval_context.rs:95-117 — split let-exprs into literals / queries /
    function expressions."""
    literals: Dict[str, PV] = {}
    queries: Dict[str, AccessQuery] = {}
    functions: Dict[str, FunctionExpr] = {}
    for each in assignments:
        v = each.value
        if isinstance(v, PV):
            literals[each.var] = v
        elif isinstance(v, AccessQuery):
            queries[each.var] = v
        else:
            functions[each.var] = v
    return literals, queries, functions


class _ScopeData:
    __slots__ = ("root", "literals", "variable_queries", "function_expressions", "resolved_variables")

    def __init__(self, root: PV, literals, queries, functions):
        self.root = root
        self.literals = literals
        self.variable_queries = queries
        self.function_expressions = functions
        self.resolved_variables: Dict[str, List[QueryResult]] = {}


class RootScope:
    """File-level scope + rule registry + status cache + recorder
    (eval_context.rs:47-53, 1062-1177)."""

    def __init__(self, rules_file: RulesFile, root: PV):
        literals, queries, functions = extract_variables(rules_file.assignments)
        self.scope = _ScopeData(root, literals, queries, functions)
        self.rules: Dict[str, List[Rule]] = {}
        for rule in rules_file.guard_rules:
            self.rules.setdefault(rule.rule_name, []).append(rule)
        self.parameterized_rules: Dict[str, ParameterizedRule] = {
            pr.rule.rule_name: pr for pr in rules_file.parameterized_rules
        }
        self.rules_status: Dict[str, Status] = {}
        self.recorder = RecordTracker()

    # RecordTracer
    def start_record(self, context: str) -> None:
        self.recorder.start_record(context)

    def end_record(self, context: str, record: RecordType) -> None:
        self.recorder.end_record(context, record)

    def reset_recorder(self) -> RecordTracker:
        old = self.recorder
        self.recorder = RecordTracker()
        return old

    # EvalContext
    def query(self, query: List) -> List[QueryResult]:
        return query_retrieval(0, query, self.root(), self)

    def root(self) -> PV:
        return self.scope.root

    def find_parameterized_rule(self, rule_name: str) -> ParameterizedRule:
        pr = self.parameterized_rules.get(rule_name)
        if pr is None:
            raise MissingValueError(
                f"Parameterized Rule with name {rule_name} was not found, "
                f"candidate {list(self.parameterized_rules)}"
            )
        return pr

    def rule_status(self, rule_name: str) -> Status:
        """eval_context.rs:1087-1115 — first non-SKIP status among
        same-named rules, cached."""
        if rule_name in self.rules_status:
            return self.rules_status[rule_name]
        rules = self.rules.get(rule_name)
        if rules is None:
            raise MissingValueError(
                f"Rule {rule_name} by that name does not exist, Rule Names = {list(self.rules)}"
            )
        from .evaluator import eval_rule  # lazy: mutual recursion

        status = Status.SKIP
        for each_rule in rules:
            s = eval_rule(each_rule, self)
            if s != Status.SKIP:
                status = s
                break
        self.rules_status[rule_name] = status
        return status

    def resolve_variable(self, variable_name: str) -> List[QueryResult]:
        """eval_context.rs:1117-1163 — single-shot caching; `some`-marked
        query assignments silently drop UnResolved entries."""
        return _resolve_variable_in(self, self.scope, variable_name)

    def add_variable_capture_key(self, variable_name: str, key: PV) -> None:
        self.scope.resolved_variables.setdefault(variable_name, []).append(
            QueryResult.resolved(key)
        )


def _resolve_variable_in(ctx, scope: _ScopeData, variable_name: str):
    if variable_name in scope.literals:
        return [QueryResult.literal(scope.literals[variable_name])]
    if variable_name in scope.resolved_variables:
        return list(scope.resolved_variables[variable_name])
    if variable_name in scope.function_expressions:
        fexpr = scope.function_expressions[variable_name]
        result = resolve_function(fexpr.name, fexpr.parameters, ctx)
        scope.resolved_variables[variable_name] = result
        return list(result)
    query = scope.variable_queries.get(variable_name)
    if query is None:
        raise MissingValueError(
            f"Could not resolve variable by name {variable_name} across scopes"
        )
    result = query_retrieval(0, query.query, ctx.root(), ctx)
    if not query.match_all:
        result = [q for q in result if q.tag == RESOLVED]
    scope.resolved_variables[variable_name] = result
    return list(result)


class BlockScope:
    """eval_context.rs:79-82, 1525-...: block-local lets over a parent."""

    def __init__(self, block: Block, root: PV, parent):
        literals, queries, functions = extract_variables(block.assignments)
        self.scope = _ScopeData(root, literals, queries, functions)
        self.parent = parent

    def start_record(self, context: str) -> None:
        self.parent.start_record(context)

    def end_record(self, context: str, record: RecordType) -> None:
        self.parent.end_record(context, record)

    def query(self, query: List) -> List[QueryResult]:
        return query_retrieval(0, query, self.root(), self)

    def root(self) -> PV:
        return self.scope.root

    def find_parameterized_rule(self, rule_name: str) -> ParameterizedRule:
        return self.parent.find_parameterized_rule(rule_name)

    def rule_status(self, rule_name: str) -> Status:
        return self.parent.rule_status(rule_name)

    def resolve_variable(self, variable_name: str) -> List[QueryResult]:
        if (
            variable_name in self.scope.literals
            or variable_name in self.scope.resolved_variables
            or variable_name in self.scope.function_expressions
            or variable_name in self.scope.variable_queries
        ):
            return _resolve_variable_in(self, self.scope, variable_name)
        return self.parent.resolve_variable(variable_name)

    def add_variable_capture_key(self, variable_name: str, key: PV) -> None:
        self.scope.resolved_variables.setdefault(variable_name, []).append(
            QueryResult.resolved(key)
        )


class ValueScope:
    """eval_context.rs:84-87: re-roots queries at a selected value."""

    __slots__ = ("root_value", "parent")

    def __init__(self, root: PV, parent):
        self.root_value = root
        self.parent = parent

    def start_record(self, context: str) -> None:
        self.parent.start_record(context)

    def end_record(self, context: str, record: RecordType) -> None:
        self.parent.end_record(context, record)

    def query(self, query: List) -> List[QueryResult]:
        # eval_context.rs:1483-1485: resolves against parent context
        return query_retrieval(0, query, self.root(), self.parent)

    def root(self) -> PV:
        return self.root_value

    def find_parameterized_rule(self, rule_name: str) -> ParameterizedRule:
        return self.parent.find_parameterized_rule(rule_name)

    def rule_status(self, rule_name: str) -> Status:
        return self.parent.rule_status(rule_name)

    def resolve_variable(self, variable_name: str) -> List[QueryResult]:
        return self.parent.resolve_variable(variable_name)

    def add_variable_capture_key(self, variable_name: str, key: PV) -> None:
        self.parent.add_variable_capture_key(variable_name, key)


# ---------------------------------------------------------------------------
# Function resolution (eval_context.rs:2437-2472)
# ---------------------------------------------------------------------------
def resolve_function(name: str, parameters: List, resolver) -> List[QueryResult]:
    args: List[List[QueryResult]] = []
    for param in parameters:
        if isinstance(param, PV):
            args.append([QueryResult.literal(param)])
        elif isinstance(param, AccessQuery):
            args.append(resolver.query(param.query))
        elif isinstance(param, FunctionExpr):
            args.append(resolve_function(param.name, param.parameters, resolver))
        else:
            raise InternalError(f"Unexpected function parameter {param!r}")
    results = call_function(name, args)
    return [QueryResult.resolved(v) for v in results if v is not None]


# ---------------------------------------------------------------------------
# Query retrieval — the recursive tree-walk (eval_context.rs:337-924)
# ---------------------------------------------------------------------------
def _unresolved(current: PV, reason: str, query_rest: List) -> QueryResult:
    return QueryResult.unresolved_(
        UnResolved(
            traversed_to=current,
            remaining_query=display_query(query_rest),
            reason=reason,
        )
    )


def query_retrieval(
    query_index: int, query: List, current: PV, resolver
) -> List[QueryResult]:
    return query_retrieval_with_converter(query_index, query, current, resolver, None)


def query_retrieval_with_converter(
    query_index: int,
    query: List,
    current: PV,
    resolver,
    converter: Optional[Callable[[str], str]],
) -> List[QueryResult]:
    if query_index >= len(query):
        return [QueryResult.resolved(current)]

    part = query[query_index]

    # %variable head (eval_context.rs:348-385)
    if query_index == 0 and part_is_variable(part):
        retrieved = resolver.resolve_variable(part_variable(part))
        resolved: List[QueryResult] = []
        for each in retrieved:
            if each.tag == UNRESOLVED:
                resolved.append(each)
                continue
            value = each.value
            index = query_index + 1
            if index < len(query) and isinstance(query[index], QAllIndices):
                index = query_index + 2
            if index < len(query):
                scope = ValueScope(value, resolver)
                resolved.extend(
                    query_retrieval_with_converter(index, query, value, scope, converter)
                )
            else:
                resolved.append(each)
        return resolved

    if isinstance(part, QThis):
        return query_retrieval_with_converter(
            query_index + 1, query, current, resolver, converter
        )

    if isinstance(part, QKey):
        return _retrieve_key(part, query_index, query, current, resolver, converter)

    if isinstance(part, QIndex):
        if current.kind == LIST:
            qr = _retrieve_index(current, part.index, current.val, query)
            if qr.tag == RESOLVED:
                return query_retrieval_with_converter(
                    query_index + 1, query, qr.value, resolver, converter
                )
            return [qr]
        return [
            _unresolved(
                current,
                f"Attempting to retrieve from index {part.index} but type is not an "
                f"array at path {current.self_path().disp()}, type {current.type_info()}",
                query[query_index:],
            )
        ]

    if isinstance(part, QAllIndices):
        return _retrieve_all_indices(part, query_index, query, current, resolver, converter)

    if isinstance(part, QAllValues):
        return _retrieve_all_values(part, query_index, query, current, resolver, converter)

    if isinstance(part, QFilter):
        return _retrieve_filter(part, query_index, query, current, resolver, converter)

    if isinstance(part, QMapKeyFilter):
        return _retrieve_map_key_filter(part, query_index, query, current, resolver, converter)

    raise InternalError(f"Unknown query part {part!r}")


def _retrieve_index(parent: PV, index: int, elements: List[PV], query: List) -> QueryResult:
    """eval_context.rs:119-140."""
    check = index if index >= 0 else -index
    if check < len(elements):
        return QueryResult.resolved(elements[check])
    return _unresolved(
        parent,
        f"Array Index out of bounds for path = {parent.self_path().disp()} on index = "
        f"{index} inside Array, remaining query = {display_query(query)}",
        query,
    )


def _accumulate(
    parent: PV, query_index: int, query: List, elements: List[PV], resolver, converter
) -> List[QueryResult]:
    """[*] over a list (eval_context.rs:142-177); empty -> UnResolved."""
    if not elements:
        return [
            _unresolved(
                parent,
                f"No more entries for value at path = {parent.self_path().disp()} on type = "
                f"{parent.type_info()} ",
                query[query_index:],
            )
        ]
    accumulated: List[QueryResult] = []
    for each in elements:
        accumulated.extend(
            query_retrieval_with_converter(query_index + 1, query, each, resolver, converter)
        )
    return accumulated


def _accumulate_map(
    parent: PV, mv, query_index: int, query: List, resolver, converter, func
) -> List[QueryResult]:
    """`.*` over a map (eval_context.rs:179-232); empty -> UnResolved.
    Each value is visited under a ValueScope rooted at that value."""
    if mv.is_empty():
        return [
            _unresolved(
                parent,
                f"No more entries for value at path = {parent.self_path().disp()} on type = "
                f"{parent.type_info()} ",
                query[query_index:],
            )
        ]
    resolved: List[QueryResult] = []
    for key_node in mv.keys:
        value = mv.values[key_node.val]
        val_resolver = ValueScope(value, resolver)
        resolved.extend(
            func(query_index + 1, query, key_node, value, val_resolver, converter)
        )
    return resolved


def _retrieve_key(part: QKey, query_index, query, current: PV, resolver, converter):
    key = part.name
    # integer-looking key -> array index (eval_context.rs:392-417)
    try:
        idx = int(key)
        is_int_key = bool(re.fullmatch(r"[+-]?[0-9]+", key))
    except ValueError:
        is_int_key = False
    if is_int_key:
        if current.kind == LIST:
            qr = _retrieve_index(current, idx, current.val, query)
            if qr.tag == RESOLVED:
                return query_retrieval_with_converter(
                    query_index + 1, query, qr.value, resolver, converter
                )
            return [qr]
        return [
            _unresolved(
                current,
                f"Attempting to retrieve from index {idx} but type is not an array "
                f"at path {current.self_path().disp()}",
                query,
            )
        ]

    if current.kind != MAP:
        return [
            _unresolved(
                current,
                f"Attempting to retrieve from key {key} but type is not an struct "
                f"type at path {current.self_path().disp()}, Type = "
                f"{current.type_info()}, Value = {rust_debug_pv(current)}",
                query[query_index:],
            )
        ]

    mv = current.val
    if part_is_variable(part):
        # variable interpolation as a key (eval_context.rs:421-526)
        var = part_variable(part)
        keys = resolver.resolve_variable(var)
        if len(query) > query_index + 1:
            nxt = query[query_index + 1]
            if isinstance(nxt, QIndex):
                check = nxt.index if nxt.index >= 0 else -nxt.index
                if check < len(keys):
                    keys = [keys[check]]
                else:
                    return [
                        _unresolved(
                            current,
                            f"Index {check} on the set of values returned for "
                            f"variable {var} on the join, is out of bounds. "
                            f"Length {len(keys)}",
                            query[query_index:],
                        )
                    ]
            elif not isinstance(nxt, (QAllIndices, QKey)):
                raise IncompatibleError(
                    f"This type of query variable interpolation is not supported "
                    f"{display_query(query)}"
                )
        acc: List[QueryResult] = []
        for each_key in keys:
            if each_key.tag == UNRESOLVED:
                ur = each_key.unresolved
                acc.append(
                    _unresolved(
                        current,
                        f"Keys returned for variable {var} could not completely "
                        f"resolve. Path traversed until {ur.traversed_to.self_path().disp()}"
                        f"{ur.reason or ''}",
                        query[query_index:],
                    )
                )
                continue
            kv = each_key.value
            if kv.kind == STRING:
                nxt_val = mv.values.get(kv.val)
                if nxt_val is not None:
                    acc.extend(
                        query_retrieval_with_converter(
                            query_index + 1, query, nxt_val, resolver, converter
                        )
                    )
                else:
                    acc.append(
                        _unresolved(
                            current,
                            f"Could not locate key = {kv.val} inside struct at path = "
                            f"{current.self_path().disp()}",
                            query[query_index:],
                        )
                    )
            elif kv.kind == LIST:
                for inner in kv.val:
                    if inner.kind == STRING:
                        nxt_val = mv.values.get(inner.val)
                        if nxt_val is not None:
                            acc.extend(
                                query_retrieval_with_converter(
                                    query_index + 1, query, nxt_val, resolver, converter
                                )
                            )
                        else:
                            acc.append(
                                _unresolved(
                                    current,
                                    f"Could not locate key = {inner.val} inside struct "
                                    f"at path = {inner.self_path().disp()}",
                                    query[query_index:],
                                )
                            )
                    else:
                        raise NotComparableError(
                            f"Variable projections inside Query {display_query(query)}, "
                            f"is returning a non-string value for key "
                            f"{inner.type_info()}"
                        )
            else:
                raise NotComparableError(
                    f"Variable projections inside Query {display_query(query)}, is "
                    f"returning a non-string value for key {kv.type_info()}"
                )
        return acc

    # plain key (eval_context.rs:527-576)
    val = mv.values.get(key)
    if val is not None:
        return query_retrieval_with_converter(
            query_index + 1, query, val, resolver, converter
        )
    if converter is not None:
        converted = converter(key)
        val = mv.values.get(converted)
        if val is not None:
            return query_retrieval_with_converter(
                query_index + 1, query, val, resolver, converter
            )
    else:
        for each_converter in CONVERTERS:
            candidate = mv.values.get(each_converter(key))
            if candidate is not None:
                return query_retrieval_with_converter(
                    query_index + 1, query, candidate, resolver, each_converter
                )
    return [
        _unresolved(
            current,
            f"Could not find key {key} inside struct at path {current.self_path().disp()}",
            query[query_index:],
        )
    ]


def _retrieve_all_indices(part: QAllIndices, query_index, query, current: PV, resolver, converter):
    """eval_context.rs:609-665."""
    if current.kind == LIST:
        return _accumulate(current, query_index, query, current.val, resolver, converter)
    if current.kind == MAP:
        if part.name is None:
            return query_retrieval_with_converter(
                query_index + 1, query, current, resolver, converter
            )

        def visit(index, q, key, value, ctx, conv):
            ctx.add_variable_capture_key(part.name, key)
            return query_retrieval_with_converter(index, q, value, ctx, conv)

        return _accumulate_map(current, current.val, query_index, query, resolver, converter, visit)
    # single value accepted where a list is expected (eval_context.rs:652-664)
    return query_retrieval_with_converter(
        query_index + 1, query, current, resolver, converter
    )


def _retrieve_all_values(part: QAllValues, query_index, query, current: PV, resolver, converter):
    """eval_context.rs:667-721."""
    if current.kind == LIST:
        return _accumulate(current, query_index, query, current.val, resolver, converter)
    if current.kind == MAP:
        report = part.name is not None

        def visit(index, q, key, value, ctx, conv):
            if report:
                ctx.add_variable_capture_key(part.name, key)
            return query_retrieval_with_converter(index, q, value, ctx, conv)

        return _accumulate_map(current, current.val, query_index, query, resolver, converter, visit)
    return query_retrieval_with_converter(
        query_index + 1, query, current, resolver, converter
    )


def _retrieve_filter(part: QFilter, query_index, query, current: PV, resolver, converter):
    """eval_context.rs:723-828 — filters run the clause CNF over each
    candidate; PASS selects, FAIL/SKIP drops (no UnResolved)."""
    from .evaluator import eval_conjunction_clauses, eval_guard_clause  # lazy

    conjunctions = part.conjunctions
    if current.kind == MAP:
        prev = query[query_index - 1] if query_index > 0 else None
        if isinstance(prev, (QAllValues, QAllIndices)):
            return _filter_check_delegate(
                conjunctions, part.name, query_index + 1, query, current, current,
                resolver, converter,
            )
        if isinstance(prev, QKey) or prev is None:
            mv = current.val
            if mv.is_empty():
                return []
            return _accumulate_map(
                current, mv, query_index, query, resolver, converter,
                lambda index, q, key, value, ctx, conv: _filter_check_delegate(
                    conjunctions, part.name, index, q, key, value, ctx, conv
                ),
            )
        raise InternalError(f"Filter after unexpected query part {prev!r}")

    if current.kind == LIST:
        selected: List[QueryResult] = []
        for each in current.val:
            context = f"Filter/List#{len(conjunctions)}"
            resolver.start_record(context)
            val_resolver = ValueScope(each, resolver)
            try:
                status = eval_conjunction_clauses(
                    conjunctions, val_resolver, eval_guard_clause
                )
            except Exception:
                resolver.end_record(context, RecordType(RecordType.FILTER, Status.FAIL))
                raise
            resolver.end_record(context, RecordType(RecordType.FILTER, status))
            if status == Status.PASS:
                selected.extend(
                    query_retrieval_with_converter(
                        query_index + 1, query, each, resolver, converter
                    )
                )
        return selected

    prev = query[query_index - 1] if query_index > 0 else None
    if isinstance(prev, QAllIndices):
        val_resolver = ValueScope(current, resolver)
        status = eval_conjunction_clauses(conjunctions, val_resolver, eval_guard_clause)
        if status == Status.PASS:
            return query_retrieval_with_converter(
                query_index + 1, query, current, resolver, converter
            )
        return []
    return [
        _unresolved(
            current,
            f"Filter on value type that was not a struct or array "
            f"{current.type_info()} {current.self_path().disp()}",
            query[query_index:],
        )
    ]


def _filter_check_delegate(
    conjunctions, name, index, query, key, value, eval_context, converter
):
    """check_and_delegate (eval_context.rs:268-313)."""
    from .evaluator import eval_conjunction_clauses, eval_guard_clause  # lazy

    context = f"Filter/Map#{len(conjunctions)}"
    eval_context.start_record(context)
    try:
        status = eval_conjunction_clauses(conjunctions, eval_context, eval_guard_clause)
    except Exception:
        eval_context.end_record(context, RecordType(RecordType.FILTER, Status.FAIL))
        raise
    eval_context.end_record(context, RecordType(RecordType.FILTER, status))
    if name is not None and status == Status.PASS:
        eval_context.add_variable_capture_key(name, key)
    if status == Status.PASS:
        return query_retrieval_with_converter(index, query, value, eval_context, converter)
    return []


def _retrieve_map_key_filter(
    part: QMapKeyFilter, query_index, query, current: PV, resolver, converter
):
    """`[ keys == ... ]` (eval_context.rs:830-922)."""
    from .evaluator import real_binary_operation  # lazy

    if current.kind != MAP:
        return [
            _unresolved(
                current,
                f"Map Filter for keys was not a struct {current.type_info()} "
                f"{current.self_path().disp()}",
                query[query_index:],
            )
        ]
    mv = current.val
    clause = part.clause
    cw = clause.compare_with
    if isinstance(cw, AccessQuery):
        rhs = query_retrieval_with_converter(0, cw.query, current, resolver, converter)
    elif isinstance(cw, PV):
        rhs = [QueryResult.literal(cw)]
    elif isinstance(cw, FunctionExpr):
        rhs = resolve_function(cw.name, cw.parameters, resolver)
    else:
        raise InternalError(f"Unexpected map key filter RHS {cw!r}")

    lhs = [QueryResult.resolved(k) for k in mv.keys]
    results = real_binary_operation(
        lhs, rhs, (clause.comparator, clause.comparator_inverse), "", None, resolver
    )
    selected: List[QueryResult] = []
    for qr, status in results:
        if qr.tag == RESOLVED and status == Status.PASS:
            if qr.value.kind == STRING:
                selected.append(QueryResult.resolved(mv.values[qr.value.val]))
        elif qr.tag == UNRESOLVED:
            selected.append(qr)
    extended: List[QueryResult] = []
    for each in selected:
        if each.tag == UNRESOLVED:
            extended.append(each)
        else:
            extended.extend(
                query_retrieval_with_converter(
                    query_index + 1, query, each.value, resolver, converter
                )
            )
    return extended
