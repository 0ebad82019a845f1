"""Wire serialization of the Guard AST and documents for the native
C++ oracle (native/oracle.cpp).

The native statuses oracle is a from-scratch C++ port of the evaluation
core (evaluator.py / scopes.py / functions.py / values.py — themselves
ports of the reference's `eval.rs` / `eval_context.rs`). Python remains
the single owner of both grammars: the DSL parser and the YAML/JSON
loaders run here, and this module flattens their outputs — the
`RulesFile` AST and located `PV` document trees — into a compact JSON
the C++ side deserializes 1:1. That keeps the native engine free of any
parser beyond one small JSON reader, and guarantees both engines
evaluate the exact same trees.

Everything is JSON-serializable losslessly except integers outside
i64 — documents containing them raise `Unserializable`, and callers
fall back to the Python oracle (the same contract as the device
encoder's `num_exotic` flag).
"""

from __future__ import annotations

import json
import math
from typing import List, Optional

from .exprs import (
    AccessQuery,
    Block,
    BlockGuardClause,
    FileLocation,
    FunctionExpr,
    GuardAccessClause,
    GuardNamedRuleClause,
    LetExpr,
    ParameterizedNamedRuleClause,
    QAllIndices,
    QAllValues,
    QFilter,
    QIndex,
    QKey,
    QMapKeyFilter,
    QThis,
    Rule,
    RulesFile,
    TypeBlock,
    WhenBlockClause,
)
from .values import (
    BOOL,
    CHAR,
    FLOAT,
    INT,
    LIST,
    MAP,
    NULL,
    RANGE_CHAR,
    RANGE_FLOAT,
    RANGE_INT,
    REGEX,
    STRING,
    PV,
)

I64_MIN = -(2**63)
I64_MAX = 2**63 - 1


class Unserializable(Exception):
    """The value cannot be represented losslessly on the wire."""


def _loc(loc: FileLocation) -> dict:
    return {"line": loc.line, "col": loc.column, "file": loc.file_name}


def _num(v):
    if isinstance(v, int) and not (I64_MIN <= v <= I64_MAX):
        raise Unserializable(f"integer {v} outside i64")
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        # JSON has no NaN/Inf; documents never contain them (loaders
        # produce finite floats), ranges neither (parser rejects)
        raise Unserializable(f"non-finite float {v}")
    return v


def pv_to_wire(pv: PV) -> dict:
    """Serialize a PV (with its path + location) to the wire dict."""
    k = pv.kind
    out: dict = {"k": k}
    p = pv.path
    if p.s or p.loc.line or p.loc.col:
        out["p"] = [p.s, p.loc.line, p.loc.col]
    if k == NULL:
        pass
    elif k in (STRING, REGEX, CHAR):
        out["s"] = pv.val
    elif k == BOOL:
        out["b"] = bool(pv.val)
    elif k == INT:
        out["i"] = _num(pv.val)
    elif k == FLOAT:
        out["f"] = _num(float(pv.val))
    elif k == LIST:
        out["items"] = [pv_to_wire(e) for e in pv.val]
    elif k == MAP:
        mv = pv.val
        out["entries"] = [
            [pv_to_wire(key_node), pv_to_wire(mv.values[key_node.val])]
            for key_node in mv.keys
        ]
    elif k in (RANGE_INT, RANGE_FLOAT, RANGE_CHAR):
        r = pv.val
        lo = r.lower if k == RANGE_CHAR else _num(r.lower)
        hi = r.upper if k == RANGE_CHAR else _num(r.upper)
        out["lo"] = lo
        out["hi"] = hi
        out["inc"] = r.inclusive
    else:
        raise Unserializable(f"unknown PV kind {k}")
    return out


def _let_value(lv) -> dict:
    if isinstance(lv, PV):
        return {"l": "pv", "pv": pv_to_wire(lv)}
    if isinstance(lv, AccessQuery):
        return {"l": "q", "q": _query(lv)}
    if isinstance(lv, FunctionExpr):
        return {
            "l": "fn",
            "name": lv.name,
            "params": [_let_value(p) for p in lv.parameters],
            "loc": _loc(lv.location),
        }
    raise Unserializable(f"unknown let value {lv!r}")


def _part(part) -> dict:
    if isinstance(part, QThis):
        return {"p": "this"}
    if isinstance(part, QKey):
        return {"p": "key", "name": part.name}
    if isinstance(part, QAllValues):
        return {"p": "all_values", "name": part.name}
    if isinstance(part, QAllIndices):
        return {"p": "all_indices", "name": part.name}
    if isinstance(part, QIndex):
        return {"p": "index", "i": part.index}
    if isinstance(part, QFilter):
        return {"p": "filter", "name": part.name, "conj": _conj(part.conjunctions)}
    if isinstance(part, QMapKeyFilter):
        c = part.clause
        return {
            "p": "keys",
            "name": part.name,
            "cmp": c.comparator.value,
            "inv": c.comparator_inverse,
            "cw": _let_value(c.compare_with),
        }
    raise Unserializable(f"unknown query part {part!r}")


def _query(q: AccessQuery) -> dict:
    return {"parts": [_part(p) for p in q.query], "match_all": q.match_all}


def _assignments(assignments: List[LetExpr]) -> list:
    return [{"var": a.var, "value": _let_value(a.value)} for a in assignments]


def _clause(c) -> dict:
    if isinstance(c, GuardAccessClause):
        ac = c.access_clause
        return {
            "t": "access",
            "query": _query(ac.query),
            "cmp": ac.comparator.value,
            "inv": ac.comparator_inverse,
            "neg": c.negation,
            "cw": None if ac.compare_with is None else _let_value(ac.compare_with),
            "msg": ac.custom_message,
            "loc": _loc(ac.location),
        }
    if isinstance(c, GuardNamedRuleClause):
        return {
            "t": "named",
            "rule": c.dependent_rule,
            "neg": c.negation,
            "msg": c.custom_message,
            "loc": _loc(c.location),
        }
    if isinstance(c, BlockGuardClause):
        return {
            "t": "block",
            "query": _query(c.query),
            "assignments": _assignments(c.block.assignments),
            "conj": _conj(c.block.conjunctions),
            "not_empty": c.not_empty,
            "loc": _loc(c.location),
        }
    if isinstance(c, WhenBlockClause):
        return {
            "t": "when",
            "conditions": _conj(c.conditions),
            "assignments": _assignments(c.block.assignments),
            "conj": _conj(c.block.conjunctions),
        }
    if isinstance(c, ParameterizedNamedRuleClause):
        return {
            "t": "call",
            "params": [_let_value(p) for p in c.parameters],
            "named": _clause(c.named_rule),
        }
    if isinstance(c, TypeBlock):
        return {
            "t": "type_block",
            "type_name": c.type_name,
            "query": [_part(p) for p in c.query],
            "conditions": None if c.conditions is None else _conj(c.conditions),
            "assignments": _assignments(c.block.assignments),
            "conj": _conj(c.block.conjunctions),
        }
    raise Unserializable(f"unknown clause {type(c).__name__}")


def _conj(conjunctions) -> list:
    return [[_clause(c) for c in disj] for disj in conjunctions]


def _rule(rule: Rule) -> dict:
    return {
        "name": rule.rule_name,
        "conditions": None if rule.conditions is None else _conj(rule.conditions),
        "assignments": _assignments(rule.block.assignments),
        "conj": _conj(rule.block.conjunctions),
    }


def rules_file_to_wire(rf: RulesFile) -> dict:
    return {
        "assignments": _assignments(rf.assignments),
        "rules": [_rule(r) for r in rf.guard_rules],
        "param_rules": [
            {"params": pr.parameter_names, "rule": _rule(pr.rule)}
            for pr in rf.parameterized_rules
        ],
    }


def rules_file_to_json(rf: RulesFile) -> str:
    return json.dumps(rules_file_to_wire(rf), ensure_ascii=False)


def doc_to_json(doc: PV) -> str:
    """Records-mode document wire: full paths + source locations (the
    record tree embeds them in reasons and report locations)."""
    return json.dumps(pv_to_wire(doc), ensure_ascii=False)


def pv_from_wire(d: dict) -> PV:
    """Inverse of pv_to_wire — rebuilds PVs emitted by the native
    engine's record tree."""
    from .values import Location, MapValue, Path, Range

    p = d.get("p")
    path = Path(p[0], Location(p[1], p[2])) if p else Path.root()
    k = d["k"]
    if k == NULL:
        return PV(path, k, None)
    if k in (STRING, REGEX, CHAR):
        return PV(path, k, d["s"])
    if k == BOOL:
        return PV(path, k, d["b"])
    if k == INT:
        return PV(path, k, d["i"])
    if k == FLOAT:
        return PV(path, k, float(d["f"]))
    if k == LIST:
        return PV(path, k, [pv_from_wire(e) for e in d["items"]])
    if k == MAP:
        mv = MapValue()
        for key_d, val_d in d["entries"]:
            key_pv = pv_from_wire(key_d)
            mv.keys.append(key_pv)
            mv.values[key_pv.val] = pv_from_wire(val_d)
        return PV(path, k, mv)
    if k in (RANGE_INT, RANGE_FLOAT, RANGE_CHAR):
        return PV(path, k, Range(d["lo"], d["hi"], d["inc"]))
    raise Unserializable(f"unknown wire kind {k}")


def records_from_wire(text: str):
    """Rebuild the EventRecord tree emitted by the native engine's
    records mode (native/oracle.cpp rec_json) so commands/report.py
    consumes it exactly as it consumes the Python evaluator's tree."""
    from .exprs import CmpOperator
    from .qresult import QueryResult, Status, UnResolved
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

    STATUS = {0: Status.PASS, 1: Status.FAIL, 2: Status.SKIP}

    def qr(d):
        t = d["t"]
        if t == "ur":
            return QueryResult.unresolved_(
                UnResolved(pv_from_wire(d["to"]), d["rem"], d["reason"])
            )
        pv = pv_from_wire(d["pv"])
        return QueryResult.literal(pv) if t == "lit" else QueryResult.resolved(pv)

    def cmp_of(p):
        return (CmpOperator(p["cmp"][0]), p["cmp"][1])

    def clause_check(p):
        cc = p["cc"]
        if cc == ClauseCheck.SUCCESS:
            return ClauseCheck.success()
        if cc == ClauseCheck.NO_VALUE_FOR_EMPTY:
            return ClauseCheck.no_value_for_empty(p["custom"])
        if cc == ClauseCheck.COMPARISON:
            return ClauseCheck.comparison(
                ComparisonClauseCheck(
                    comparison=cmp_of(p),
                    from_=qr(p["from"]),
                    to=None if p["to"] is None else qr(p["to"]),
                    status=STATUS[p["status"]],
                    message=p["msg"],
                    custom_message=p["custom"],
                )
            )
        if cc == ClauseCheck.IN_COMPARISON:
            return ClauseCheck.in_comparison(
                InComparisonCheck(
                    comparison=cmp_of(p),
                    from_=qr(p["from"]),
                    to=[qr(e) for e in p["to_list"]],
                    status=STATUS[p["status"]],
                    message=p["msg"],
                    custom_message=p["custom"],
                )
            )
        if cc == ClauseCheck.UNARY:
            return ClauseCheck.unary(
                UnaryValueCheck(
                    value=ValueCheck(
                        from_=qr(p["from"]),
                        status=STATUS[p["status"]],
                        message=p["msg"],
                        custom_message=p["custom"],
                    ),
                    comparison=cmp_of(p),
                )
            )
        if cc == ClauseCheck.DEPENDENT_RULE:
            return ClauseCheck.dependent_rule(
                MissingValueCheck(
                    rule=p["rule"],
                    status=STATUS[p["status"]],
                    message=p["msg"],
                    custom_message=p["custom"],
                )
            )
        if cc == ClauseCheck.MISSING_BLOCK_VALUE:
            return ClauseCheck.missing_block_value(
                ValueCheck(
                    from_=qr(p["from"]),
                    status=STATUS[p["status"]],
                    message=p["msg"],
                    custom_message=p["custom"],
                )
            )
        raise Unserializable(f"unknown clause check {cc}")

    def record(d) -> EventRecord:
        ev = EventRecord(context=d["c"])
        k = d["k"]
        if k is not None:
            p = d.get("p", {})
            if k in (RecordType.FILE_CHECK, RecordType.RULE_CHECK):
                payload = NamedStatus(
                    name=p["name"], status=STATUS[p["status"]], message=p["msg"]
                )
            elif k in (
                RecordType.RULE_CONDITION,
                RecordType.TYPE_CONDITION,
                RecordType.TYPE_BLOCK,
                RecordType.FILTER,
                RecordType.WHEN_CONDITION,
            ):
                payload = STATUS[p["status"]]
            elif k == RecordType.TYPE_CHECK:
                payload = TypeBlockCheck(
                    type_name=p["type_name"],
                    block=BlockCheck(
                        at_least_one_matches=p["alo"],
                        status=STATUS[p["status"]],
                        message=p["msg"],
                    ),
                )
            elif k in (
                RecordType.WHEN_CHECK,
                RecordType.DISJUNCTION,
                RecordType.BLOCK_GUARD_CHECK,
                RecordType.GUARD_CLAUSE_BLOCK_CHECK,
            ):
                payload = BlockCheck(
                    at_least_one_matches=p["alo"],
                    status=STATUS[p["status"]],
                    message=p["msg"],
                )
            elif k == RecordType.CLAUSE_VALUE_CHECK:
                payload = clause_check(p)
            else:
                raise Unserializable(f"unknown record kind {k}")
            ev.container = RecordType(k, payload)
        ev.children = [record(ch) for ch in d["ch"]]
        return ev

    return record(json.loads(text))


def _pv_to_compact(pv: PV, locs: bool):
    k = pv.kind
    if k == NULL:
        head = (0,)
    elif k in (STRING, REGEX, CHAR):
        head = (k, pv.val)
    elif k == BOOL:
        head = (3, bool(pv.val))
    elif k == INT:
        head = (4, _num(pv.val))
    elif k == FLOAT:
        head = (5, _num(float(pv.val)))
    elif k == LIST:
        head = (7, [_pv_to_compact(e, locs) for e in pv.val])
    elif k == MAP:
        mv = pv.val
        if locs:
            head = (
                8,
                [
                    [
                        kn.val,
                        kn.path.loc.line,
                        kn.path.loc.col,
                        _pv_to_compact(mv.values[kn.val], locs),
                    ]
                    for kn in mv.keys
                ],
            )
        else:
            head = (
                8,
                [[kn.val, _pv_to_compact(mv.values[kn.val], locs)] for kn in mv.keys],
            )
    else:
        raise Unserializable(f"kind {k} cannot appear in a document")
    if locs:
        loc = pv.path.loc
        return head + (loc.line, loc.col)
    return head


def doc_to_compact(doc: PV, locs: bool = False) -> str:
    """Document wire: positional [kind, payload] arrays, about 3x
    leaner than the rich wire and parsed by a dedicated direct scanner
    in C++. Statuses mode omits paths/locations entirely (C++ derives
    paths); records mode (`locs=True`) appends per-node and per-key
    line/col trailers so report locations match the loader's."""
    return json.dumps(_pv_to_compact(doc, locs), ensure_ascii=False)
