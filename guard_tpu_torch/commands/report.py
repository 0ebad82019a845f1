"""File-level evaluation reports derived from the event-record tree.

Equivalent of `simplified_json_from_root` + `report_all_failed_clauses_
for_rules` (`guard/src/rules/eval_context.rs:1966-2435`):
walks the `EventRecord` tree a completed evaluation produced and builds a
`FileReport` dict with the same shape the reference serializes —
`{name, metadata, status, not_compliant: [ClauseReport...],
not_applicable: [...], compliant: [...]}` — which feeds the structured
JSON/YAML, SARIF and JUnit reporters as well as the console summary.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.exprs import CmpOperator
from ..core.qresult import RESOLVED, UNRESOLVED, QueryResult, Status
from ..core.records import (
    BlockCheck,
    ClauseCheck,
    EventRecord,
    NamedStatus,
    RecordType,
)
from ..core.values import PV


def get_rule_name(rules_file_name: str, name: str) -> str:
    """summary_table.rs get_rule_name: strip a leading "<file>/"."""
    prefix = rules_file_name + "/"
    return name[len(prefix):] if name.startswith(prefix) else name


def _pv_json(pv: PV) -> dict:
    """PathAwareValue serialization {path, value} (path_value.rs:864-880)."""
    return {"path": pv.self_path().s, "value": pv.to_plain()}


def _pv_display(pv: PV) -> str:
    loc = pv.self_path().loc
    import json

    return (
        f"Path={pv.self_path().s}[L:{loc.line},C:{loc.col}] "
        f"Value={json.dumps(pv.to_plain(), separators=(',', ':'))}"
    )


def _ur_json(ur) -> dict:
    return {
        "traversed_to": _pv_json(ur.traversed_to),
        "remaining_query": ur.remaining_query,
        "reason": ur.reason,
    }


def _cmp_json(cmp) -> list:
    op, negated = cmp
    return [op.value, negated]


def _location_json(pv: Optional[PV]) -> Optional[dict]:
    if pv is None:
        return None
    loc = pv.self_path().loc
    return {"line": loc.line, "col": loc.col}


_UNARY_FAIL_MSG = {
    CmpOperator.Exists: ("did not exist", "existed"),
    CmpOperator.Empty: ("was not empty", "was empty"),
    CmpOperator.IsList: ("was not list", "was a list "),
    CmpOperator.IsMap: ("was not struct", "was a struct"),
    CmpOperator.IsString: ("was not string", "was a string "),
    CmpOperator.IsInt: ("was not int", "was int"),
    CmpOperator.IsBool: ("was not bool", "was bool"),
    CmpOperator.IsNull: ("was not null", "was null"),
    CmpOperator.IsFloat: ("was not float", "was float"),
}

_BINARY_FAIL_MSG = {
    CmpOperator.Eq: ("not equal to", "equal to"),
    CmpOperator.Le: ("not less than equal to", "less than equal to"),
    CmpOperator.Lt: ("not less than", "less than"),
    CmpOperator.Ge: ("not greater than equal", "greater than equal to"),
    CmpOperator.Gt: ("not greater than", "greater than"),
    CmpOperator.In: ("not in", "in"),
}


def _failed_clauses(children: List[EventRecord]) -> List[dict]:
    """report_all_failed_clauses_for_rules (eval_context.rs:1966-2400)."""
    clauses: List[dict] = []
    for current in children:
        c = current.container
        if c is None:
            clauses.extend(_failed_clauses(current.children))
            continue
        kind = c.kind
        if kind == RecordType.RULE_CHECK and c.payload.status == Status.FAIL:
            clauses.append(
                {
                    "Rule": {
                        "name": c.payload.name,
                        "metadata": {},
                        "messages": {
                            "custom_message": c.payload.message,
                            "error_message": None,
                        },
                        "checks": _failed_clauses(current.children),
                    }
                }
            )
        elif kind == RecordType.BLOCK_GUARD_CHECK and c.payload.status == Status.FAIL:
            if not current.children:
                clauses.append(
                    {
                        "Block": {
                            "context": current.context,
                            "messages": {
                                "custom_message": None,
                                "error_message": "query for block clause did not retrieve any value",
                            },
                            "unresolved": None,
                        }
                    }
                )
            else:
                clauses.extend(_failed_clauses(current.children))
        elif kind == RecordType.DISJUNCTION and c.payload.status == Status.FAIL:
            clauses.append(
                {"Disjunctions": {"checks": _failed_clauses(current.children)}}
            )
        elif kind in (
            RecordType.GUARD_CLAUSE_BLOCK_CHECK,
            RecordType.TYPE_BLOCK,
            RecordType.TYPE_CHECK,
            RecordType.WHEN_CHECK,
        ) and c.status() == Status.FAIL:
            clauses.extend(_failed_clauses(current.children))
        elif kind == RecordType.CLAUSE_VALUE_CHECK:
            clauses.extend(_clause_value_report(current, c.payload))
    return clauses


def _clause_value_report(current: EventRecord, check: ClauseCheck) -> List[dict]:
    k = check.kind
    if k == ClauseCheck.SUCCESS:
        return []
    if k == ClauseCheck.NO_VALUE_FOR_EMPTY:
        custom = (check.payload or "").replace("\n", ";")
        return [
            {
                "Clause": {
                    "Unary": {
                        "context": current.context,
                        "check": {"UnResolvedContext": current.context},
                        "messages": {
                            "custom_message": custom,
                            "error_message": (
                                f"Check was not compliant as variable in context "
                                f"[{current.context}] was not empty"
                            ),
                        },
                    }
                }
            }
        ]
    if k == ClauseCheck.DEPENDENT_RULE:
        missing = check.payload
        return [
            {
                "Clause": {
                    "Unary": {
                        "context": current.context,
                        "check": {"UnResolvedContext": missing.rule},
                        "messages": {
                            "custom_message": missing.custom_message or "",
                            "error_message": (
                                f"Check was not compliant as dependent rule "
                                f"[{missing.rule}] did not PASS. Context "
                                f"[{current.context}]"
                            ),
                        },
                    }
                }
            }
        ]
    if k == ClauseCheck.MISSING_BLOCK_VALUE:
        missing = check.payload
        ur = missing.from_.unresolved
        return [
            {
                "Block": {
                    "context": current.context,
                    "messages": {
                        "custom_message": missing.custom_message or "",
                        "error_message": (
                            f"Check was not compliant as property "
                            f"[{ur.remaining_query}] is missing. Value traversed "
                            f"to [{_pv_display(ur.traversed_to)}]"
                        ),
                        "location": _location_json(ur.traversed_to),
                    },
                    "unresolved": _ur_json(ur),
                }
            }
        ]
    if k == ClauseCheck.UNARY:
        uc = check.payload
        if uc.value.status != Status.FAIL:
            return []
        cmp_op, cmp_not = uc.comparison
        pair = _UNARY_FAIL_MSG.get(cmp_op, ("was not float", "was float"))
        cmp_msg = pair[1] if cmp_not else pair[0]
        err = f"Error = [{uc.value.message}]" if uc.value.message else ""
        from_ = uc.value.from_
        if from_.tag == UNRESOLVED:
            ur = from_.unresolved
            message = (
                f"Check was not compliant as property [{ur.remaining_query}] is "
                f"missing. Value traversed to [{_pv_display(ur.traversed_to)}].{err}"
            )
            check_json = {
                "UnResolved": {
                    "value": _ur_json(ur),
                    "comparison": _cmp_json(uc.comparison),
                }
            }
            location = _location_json(ur.traversed_to)
        else:
            res = from_.value
            message = (
                f"Check was not compliant as property [{res.self_path().s}] "
                f"{cmp_msg}.{err}"
            )
            check_json = {
                "Resolved": {
                    "value": _pv_json(res),
                    "comparison": _cmp_json(uc.comparison),
                }
            }
            location = _location_json(res)
        return [
            {
                "Clause": {
                    "Unary": {
                        "check": check_json,
                        "context": current.context,
                        "messages": {
                            "custom_message": uc.value.custom_message or "",
                            "error_message": message,
                            "location": location,
                        },
                    }
                }
            }
        ]
    if k == ClauseCheck.COMPARISON:
        cc = check.payload
        if cc.status != Status.FAIL:
            return []
        cmp_op, cmp_not = cc.comparison
        err = f" Error = [{cc.message}]" if cc.message else ""
        from_ = cc.from_
        if from_.tag == UNRESOLVED:
            ur = from_.unresolved
            message = (
                f"Check was not compliant as property [{ur.remaining_query}] to "
                f"compare from is missing. Value traversed to "
                f"[{_pv_display(ur.traversed_to)}].{err}"
            )
            return [
                {
                    "Clause": {
                        "Binary": {
                            "context": current.context,
                            "messages": {
                                "custom_message": cc.custom_message or "",
                                "error_message": message,
                                "location": _location_json(ur.traversed_to),
                            },
                            "check": {
                                "UnResolved": {
                                    "value": _ur_json(ur),
                                    "comparison": _cmp_json(cc.comparison),
                                }
                            },
                        }
                    }
                }
            ]
        res = from_.value
        if cc.to is None:
            return []
        to = cc.to
        if to.tag == UNRESOLVED:
            ur = to.unresolved
            message = (
                f"Check was not compliant as property [{ur.remaining_query}] to "
                f"compare to is missing. Value traversed to "
                f"[{_pv_display(ur.traversed_to)}].{err}"
            )
            return [
                {
                    "Clause": {
                        "Binary": {
                            "context": current.context,
                            "messages": {
                                "custom_message": cc.custom_message or "",
                                "error_message": message,
                                "location": _location_json(ur.traversed_to),
                            },
                            "check": {
                                "UnResolved": {
                                    "value": _ur_json(ur),
                                    "comparison": _cmp_json(cc.comparison),
                                }
                            },
                        }
                    }
                }
            ]
        pair = _BINARY_FAIL_MSG.get(cmp_op, ("not equal to", "equal to"))
        op_msg = pair[1] if cmp_not else pair[0]
        import json as _json

        message = (
            f"Check was not compliant as property value "
            f"[{_pv_display(res)}] {op_msg} value [{_pv_display(to.value)}].{err}"
        )
        return [
            {
                "Clause": {
                    "Binary": {
                        "context": current.context,
                        "messages": {
                            "custom_message": cc.custom_message or "",
                            "error_message": message,
                            # the LHS data property drives SARIF locations and
                            # code excerpts (cfn.rs emit_code uses bc.from)
                            "location": _location_json(res),
                        },
                        "check": {
                            "Resolved": {
                                "from": _pv_json(res),
                                "to": _pv_json(to.value),
                                "comparison": _cmp_json(cc.comparison),
                            }
                        },
                    }
                }
            }
        ]
    if k == ClauseCheck.IN_COMPARISON:
        ic = check.payload
        if ic.status != Status.FAIL:
            return []
        from_pv = ic.from_.any_value()
        if from_pv is None:
            from_pv = ic.from_.unresolved.traversed_to
        to_vals = [t.value for t in ic.to if t.tag != UNRESOLVED]
        message = (
            f"Check was not compliant as property [{from_pv.self_path().s}] was "
            f"not present in [{[v.to_plain() for v in to_vals]}]"
        )
        return [
            {
                "Clause": {
                    "Binary": {
                        "context": current.context,
                        "messages": {
                            "custom_message": ic.custom_message,
                            "error_message": message,
                            "location": _location_json(from_pv),
                        },
                        "check": {
                            "InResolved": {
                                "from": _pv_json(from_pv),
                                "to": [_pv_json(v) for v in to_vals],
                                "comparison": _cmp_json(ic.comparison),
                            }
                        },
                    }
                }
            }
        ]
    return []


def simplified_report_from_root(root: EventRecord, data_file_name: str) -> dict:
    """simplified_json_from_root (eval_context.rs:2402-2435)."""
    if root.container is None or root.container.kind != RecordType.FILE_CHECK:
        raise ValueError("root record is not a FileCheck")
    status: Status = root.container.payload.status
    compliant = set()
    not_applicable = set()
    failed_records: List[EventRecord] = []
    for each in root.children:
        c = each.container
        if c is not None and c.kind == RecordType.RULE_CHECK:
            if c.payload.status == Status.PASS:
                compliant.add(c.payload.name)
            elif c.payload.status == Status.SKIP:
                not_applicable.add(c.payload.name)
            else:
                failed_records.append(each)
    return {
        "name": data_file_name,
        "metadata": {},
        "status": status.value,
        "not_compliant": _failed_clauses(failed_records),
        "not_applicable": sorted(not_applicable),
        "compliant": sorted(compliant),
    }


# ---------------------------------------------------------------------------
# Flat view used by console / SARIF / JUnit reporters
# ---------------------------------------------------------------------------
def iter_clause_failures(report: dict):
    """Yield (rule_name, clause_dict) for every leaf failure."""

    def walk(rule_name: str, node: dict):
        if "Rule" in node:
            rr = node["Rule"]
            for child in rr["checks"]:
                yield from walk(rr["name"], child)
        elif "Disjunctions" in node:
            for child in node["Disjunctions"]["checks"]:
                yield from walk(rule_name, child)
        elif "Block" in node:
            yield rule_name, node["Block"]
        elif "Clause" in node:
            inner = node["Clause"]
            payload = inner.get("Unary") or inner.get("Binary")
            yield rule_name, payload

    for nc in report["not_compliant"]:
        yield from walk("", nc)


def rule_statuses_from_root(root: EventRecord) -> Dict[str, Status]:
    """Top-level rule name -> status map for summaries."""
    out: Dict[str, Status] = {}
    for each in root.children:
        c = each.container
        if c is not None and c.kind == RecordType.RULE_CHECK:
            name = c.payload.name
            prev = out.get(name)
            if prev is None or (prev == Status.SKIP and c.payload.status != Status.SKIP):
                out[name] = c.payload.status
            elif c.payload.status == Status.FAIL:
                out[name] = Status.FAIL
    return out


# ---------------------------------------------------------------------------
# serde EventRecord encoding (`validate --print-json`, run_checks verbose)
# ---------------------------------------------------------------------------
def _serde_block(b: BlockCheck) -> dict:
    return {
        "at_least_one_matches": b.at_least_one_matches,
        "status": b.status.value,
        "message": b.message,
    }


def _serde_qr(qr: QueryResult):
    if qr.tag == UNRESOLVED:
        return {"UnResolved": _ur_json(qr.unresolved)}
    tag = "Resolved" if qr.tag == RESOLVED else "Literal"
    return {tag: _pv_json(qr.value)}


def _serde_value_check(v) -> dict:
    return {
        "from": _serde_qr(v.from_),
        "message": v.message,
        "custom_message": v.custom_message,
        "status": v.status.value,
    }


def _serde_clause_check(cc: ClauseCheck):
    k = cc.kind
    if k == ClauseCheck.SUCCESS:
        return "Success"
    if k == ClauseCheck.COMPARISON:
        p = cc.payload
        return {
            "Comparison": {
                "comparison": _cmp_json(p.comparison),
                "from": _serde_qr(p.from_),
                "to": _serde_qr(p.to) if p.to is not None else None,
                "message": p.message,
                "custom_message": p.custom_message,
                "status": p.status.value,
            }
        }
    if k == ClauseCheck.IN_COMPARISON:
        p = cc.payload
        return {
            "InComparison": {
                "comparison": _cmp_json(p.comparison),
                "from": _serde_qr(p.from_),
                "to": [_serde_qr(t) for t in p.to],
                "message": p.message,
                "custom_message": p.custom_message,
                "status": p.status.value,
            }
        }
    if k == ClauseCheck.UNARY:
        p = cc.payload
        return {
            "Unary": {
                "value": _serde_value_check(p.value),
                "comparison": _cmp_json(p.comparison),
            }
        }
    if k == ClauseCheck.NO_VALUE_FOR_EMPTY:
        return {"NoValueForEmptyCheck": cc.payload}
    if k == ClauseCheck.DEPENDENT_RULE:
        p = cc.payload
        return {
            "DependentRule": {
                "rule": p.rule,
                "message": p.message,
                "custom_message": p.custom_message,
                "status": p.status.value,
            }
        }
    # MISSING_BLOCK_VALUE
    return {"MissingBlockValue": _serde_value_check(cc.payload)}


_STATUS_PAYLOAD_KINDS = frozenset(
    (
        RecordType.RULE_CONDITION,
        RecordType.TYPE_CONDITION,
        RecordType.TYPE_BLOCK,
        RecordType.FILTER,
        RecordType.WHEN_CONDITION,
    )
)

_BLOCK_PAYLOAD_KINDS = frozenset(
    (
        RecordType.WHEN_CHECK,
        RecordType.DISJUNCTION,
        RecordType.BLOCK_GUARD_CHECK,
        RecordType.GUARD_CLAUSE_BLOCK_CHECK,
    )
)


def _serde_container(rt: Optional[RecordType]):
    if rt is None:
        return None
    k = rt.kind
    if k in (RecordType.FILE_CHECK, RecordType.RULE_CHECK):
        p: NamedStatus = rt.payload
        payload = {"name": p.name, "status": p.status.value, "message": p.message}
    elif k in _STATUS_PAYLOAD_KINDS:
        payload = rt.payload.value  # bare Status string
    elif k == RecordType.TYPE_CHECK:
        payload = {
            "type_name": rt.payload.type_name,
            "block": _serde_block(rt.payload.block),
        }
    elif k in _BLOCK_PAYLOAD_KINDS:
        payload = _serde_block(rt.payload)
    else:  # CLAUSE_VALUE_CHECK
        payload = _serde_clause_check(rt.payload)
    return {k: payload}


def serde_record_json(record: EventRecord) -> dict:
    """The reference's serde encoding of the EventRecord tree
    (`eval_context.rs:41-45` + the Serialize derives over
    `rules/mod.rs:165-355`, externally-tagged enums, struct fields in
    declaration order) — the machine-readable trace `--print-json`
    emits (`validate.rs:744-751`) and `run_checks` returns when
    verbose (`helper.rs:63`), pinned by `guard/tests/functional.rs:7-80`."""
    return {
        "context": record.context,
        "container": _serde_container(record.container),
        "children": [serde_record_json(c) for c in record.children],
    }
