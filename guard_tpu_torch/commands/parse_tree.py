"""The `parse-tree` command: dump a rule file's AST as JSON or YAML.

A copy of the JAX package's guard_tpu/commands/parse_tree.py (host
only): the equivalent of cfn-guard's
`guard/src/commands/parse_tree.rs:46-64`.
The serialization mirrors serde's externally-tagged enum shape so the
output structure lines up with the reference's parse trees
(e.g. `{"Key": "Resources"}`, `{"Filter": [name, conjunctions]}`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import yaml

from ..core.errors import ParseError
from ..core.exprs import (
    AccessQuery,
    BlockGuardClause,
    FunctionExpr,
    GuardAccessClause,
    GuardNamedRuleClause,
    ParameterizedNamedRuleClause,
    QAllIndices,
    QAllValues,
    QFilter,
    QIndex,
    QKey,
    QMapKeyFilter,
    QThis,
    TypeBlock,
    WhenBlockClause,
)
from ..core.parser import parse_rules_file
from ..core.values import PV
from ..utils.io import Reader, Writer

SUCCESS = 0
ERROR = 5


def query_part_json(part):
    if isinstance(part, QThis):
        return "This"
    if isinstance(part, QKey):
        return {"Key": part.name}
    if isinstance(part, QAllValues):
        return {"AllValues": part.name}
    if isinstance(part, QAllIndices):
        return {"AllIndices": part.name}
    if isinstance(part, QIndex):
        return {"Index": part.index}
    if isinstance(part, QFilter):
        return {"Filter": [part.name, conjunctions_json(part.conjunctions)]}
    if isinstance(part, QMapKeyFilter):
        return {
            "MapKeyFilter": [
                part.name,
                {
                    "comparator": [part.clause.comparator.value, part.clause.comparator_inverse],
                    "compare_with": let_value_json(part.clause.compare_with),
                },
            ]
        }
    raise ValueError(f"unknown query part {part!r}")


def pv_json(pv: PV):
    return {"path": pv.self_path().s, "value": pv.to_plain()}


def let_value_json(lv):
    if isinstance(lv, PV):
        return {"Value": pv_json(lv)}
    if isinstance(lv, AccessQuery):
        return {"AccessClause": access_query_json(lv)}
    if isinstance(lv, FunctionExpr):
        return {
            "FunctionCall": {
                "parameters": [let_value_json(p) for p in lv.parameters],
                "name": lv.name,
                "location": location_json(lv.location),
            }
        }
    raise ValueError(f"unknown let value {lv!r}")


def location_json(loc):
    return {"line": loc.line, "column": loc.column}


def access_query_json(q: AccessQuery):
    return {
        "query": [query_part_json(p) for p in q.query],
        "match_all": q.match_all,
    }


def clause_json(c):
    if isinstance(c, GuardAccessClause):
        return {
            "Clause": {
                "access_clause": {
                    "query": access_query_json(c.access_clause.query),
                    "comparator": [
                        c.access_clause.comparator.value,
                        c.access_clause.comparator_inverse,
                    ],
                    "compare_with": (
                        let_value_json(c.access_clause.compare_with)
                        if c.access_clause.compare_with is not None
                        else None
                    ),
                    "custom_message": c.access_clause.custom_message,
                    "location": location_json(c.access_clause.location),
                },
                "negation": c.negation,
            }
        }
    if isinstance(c, GuardNamedRuleClause):
        return {
            "NamedRule": {
                "dependent_rule": c.dependent_rule,
                "negation": c.negation,
                "custom_message": c.custom_message,
                "location": location_json(c.location),
            }
        }
    if isinstance(c, ParameterizedNamedRuleClause):
        return {
            "ParameterizedNamedRule": {
                "parameters": [let_value_json(p) for p in c.parameters],
                "named_rule": clause_json(c.named_rule)["NamedRule"],
            }
        }
    if isinstance(c, BlockGuardClause):
        return {
            "BlockClause": {
                "query": access_query_json(c.query),
                "block": block_json(c.block),
                "location": location_json(c.location),
                "not_empty": c.not_empty,
            }
        }
    if isinstance(c, WhenBlockClause):
        return {
            "WhenBlock": [conjunctions_json(c.conditions), block_json(c.block)]
        }
    if isinstance(c, TypeBlock):
        return {
            "TypeBlock": {
                "type_name": c.type_name,
                "conditions": conjunctions_json(c.conditions) if c.conditions else None,
                "block": block_json(c.block),
                "query": [query_part_json(p) for p in c.query],
            }
        }
    raise ValueError(f"unknown clause {c!r}")


def conjunctions_json(conjunctions):
    return [[clause_json(c) for c in disjunction] for disjunction in conjunctions]


def rule_clause_json(c):
    """RuleClause serialization (exprs.rs:257-261): GuardClause variants
    gain an extra `Clause` enum layer inside rule bodies; when/type
    blocks are RuleClause-level variants."""
    if isinstance(c, (WhenBlockClause, TypeBlock)):
        return clause_json(c)
    return {"Clause": clause_json(c)}


def rule_block_json(b):
    return {
        "assignments": [
            {"var": a.var, "value": let_value_json(a.value)} for a in b.assignments
        ],
        "conjunctions": [
            [rule_clause_json(c) for c in disjunction]
            for disjunction in b.conjunctions
        ],
    }


def block_json(b):
    return {
        "assignments": [
            {"var": a.var, "value": let_value_json(a.value)} for a in b.assignments
        ],
        "conjunctions": conjunctions_json(b.conjunctions),
    }


def rules_file_json(rf):
    return {
        "assignments": [
            {"var": a.var, "value": let_value_json(a.value)} for a in rf.assignments
        ],
        "guard_rules": [
            {
                "rule_name": r.rule_name,
                "conditions": conjunctions_json(r.conditions) if r.conditions else None,
                "block": rule_block_json(r.block),
            }
            for r in rf.guard_rules
        ],
        "parameterized_rules": [
            {
                "parameter_names": pr.parameter_names,
                "rule": {
                    "rule_name": pr.rule.rule_name,
                    "conditions": None,
                    "block": rule_block_json(pr.rule.block),
                },
            }
            for rf_pr in [rf.parameterized_rules]
            for pr in rf_pr
        ],
    }


@dataclass
class ParseTree:
    rules: Optional[str] = None
    output: Optional[str] = None
    print_json: bool = False
    print_yaml: bool = False

    def execute(self, writer: Writer, reader: Reader) -> int:
        content = Path_read(self.rules) if self.rules else reader.read()
        file_name = self.rules or ""
        try:
            rf = parse_rules_file(content, file_name)
        except ParseError as e:
            writer.writeln_err(str(e))
            return ERROR
        if rf is None:
            return SUCCESS
        tree = rules_file_json(rf)
        # reference default is YAML; --print-json switches
        # (parse_tree.rs:46-64, serde writers emit no trailing newline)
        if self.print_json:
            writer.write(json.dumps(tree, indent=2))
        else:
            writer.write(
                yaml.safe_dump(
                    tree, sort_keys=False, default_flow_style=False, width=2**31
                )
            )
        return SUCCESS


def Path_read(path: str) -> str:
    from pathlib import Path

    return Path(path).read_text()
