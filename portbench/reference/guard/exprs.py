"""Guard DSL abstract syntax tree.

Python equivalent of `guard/src/rules/exprs.rs`:
`RulesFile`/`Rule`/`ParameterizedRule` (exprs.rs:277-284, 264-274),
`GuardClause` variants (exprs.rs:225-231), `QueryPart` (exprs.rs:65-73),
CNF encoding `Conjunctions<T> = list[list[T]]` (exprs.rs:174-175).

The AST is also the input of the TPU lowering pass
(ops/ir.py), so every node is a plain, cheap dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Union

from .values import PV

# ---------------------------------------------------------------------------
# Comparison operators (values.rs:22-39)
# ---------------------------------------------------------------------------
class CmpOperator(str, Enum):
    Eq = "Eq"
    In = "In"
    Gt = "Gt"
    Lt = "Lt"
    Le = "Le"
    Ge = "Ge"
    Exists = "Exists"
    Empty = "Empty"
    IsString = "IsString"
    IsList = "IsList"
    IsMap = "IsMap"
    IsBool = "IsBool"
    IsInt = "IsInt"
    IsFloat = "IsFloat"
    IsNull = "IsNull"

    def is_unary(self) -> bool:
        # values.rs:42-55
        return self in _UNARY

    def display(self) -> str:
        return _CMP_DISPLAY[self]


_UNARY = {
    CmpOperator.Exists,
    CmpOperator.Empty,
    CmpOperator.IsString,
    CmpOperator.IsBool,
    CmpOperator.IsList,
    CmpOperator.IsInt,
    CmpOperator.IsMap,
    CmpOperator.IsFloat,
    CmpOperator.IsNull,
}

_CMP_DISPLAY = {
    CmpOperator.Eq: "EQUALS",
    CmpOperator.In: "IN",
    CmpOperator.Gt: "GREATER THAN",
    CmpOperator.Lt: "LESS THAN",
    CmpOperator.Ge: "GREATER THAN EQUALS",
    CmpOperator.Le: "LESS THAN EQUALS",
    CmpOperator.Exists: "EXISTS",
    CmpOperator.Empty: "EMPTY",
    CmpOperator.IsString: "IS STRING",
    CmpOperator.IsBool: "IS BOOL",
    CmpOperator.IsInt: "IS INT",
    CmpOperator.IsList: "IS LIST",
    CmpOperator.IsMap: "IS MAP",
    CmpOperator.IsNull: "IS NULL",
    CmpOperator.IsFloat: "IS FLOAT",
}


@dataclass
class FileLocation:
    """exprs.rs:12-18."""

    line: int = 0
    column: int = 0
    file_name: str = ""

    def __str__(self):
        return f"Location[file:{self.file_name}, line:{self.line}, column:{self.column}]"


# ---------------------------------------------------------------------------
# Query parts (exprs.rs:65-73)
# ---------------------------------------------------------------------------
@dataclass
class QThis:
    """`this` keyword."""

    def display(self) -> str:
        return "_"


@dataclass
class QKey:
    name: str

    def display(self) -> str:
        return self.name


@dataclass
class QAllValues:
    """`.*` — all values of a map (capture name optional)."""

    name: Optional[str] = None

    def display(self) -> str:
        return "*"


@dataclass
class QAllIndices:
    """`[*]` — all elements of a list (capture name optional)."""

    name: Optional[str] = None

    def display(self) -> str:
        return "[*]"


@dataclass
class QIndex:
    index: int

    def display(self) -> str:
        return str(self.index)


@dataclass
class QFilter:
    """`[ <cnf clauses> ]` predicate filter."""

    name: Optional[str]
    conjunctions: "Conjunctions"  # Conjunctions[GuardClause]

    def display(self) -> str:
        return f"{self.name or ''} (filter-clauses)"


@dataclass
class QMapKeyFilter:
    """`[ keys == ... ]` map-key filter."""

    name: Optional[str]
    clause: "MapKeyFilterClause"

    def display(self) -> str:
        return f"{self.name or ''} (map-key-filter-clauses)"


QueryPart = Union[QThis, QKey, QAllValues, QAllIndices, QIndex, QFilter, QMapKeyFilter]


def part_is_variable(part) -> bool:
    """exprs.rs:76-83."""
    return isinstance(part, QKey) and part.name.startswith("%")


def part_variable(part) -> Optional[str]:
    """exprs.rs:84-94."""
    if isinstance(part, QKey) and part.name.startswith("%"):
        return part.name[1:]
    return None


def display_query(parts: List[QueryPart]) -> str:
    """SliceDisplay (exprs.rs:286-303)."""
    out = ".".join(p.display() for p in parts)
    return out.replace(".[", "[")


@dataclass
class AccessQuery:
    """exprs.rs:139-142 — `some` sets match_all=False."""

    query: List[QueryPart]
    match_all: bool = True

    def display(self) -> str:
        return display_query(self.query)


# ---------------------------------------------------------------------------
# Let values & function calls (exprs.rs:31-35, 218-222)
# ---------------------------------------------------------------------------
@dataclass
class FunctionExpr:
    name: str  # validated against FUNCTIONS registry at parse time
    parameters: List["LetValue"]
    location: FileLocation = field(default_factory=FileLocation)

    def display(self) -> str:
        return f"{self.name}({', '.join(display_let_value(p) for p in self.parameters)})"


# LetValue is one of: PV (literal), AccessQuery, FunctionExpr
LetValue = Union[PV, AccessQuery, FunctionExpr]


def display_let_value(lv: LetValue) -> str:
    if isinstance(lv, AccessQuery):
        return lv.display()
    if isinstance(lv, FunctionExpr):
        return lv.display()
    from .values import value_only_display

    return value_only_display(lv)


@dataclass
class LetExpr:
    """`let var = value|query|fn()` (exprs.rs:43-47)."""

    var: str
    value: LetValue


# ---------------------------------------------------------------------------
# Clauses (exprs.rs:146-231)
# ---------------------------------------------------------------------------
@dataclass
class AccessClause:
    """exprs.rs:146-153."""

    query: AccessQuery
    comparator: CmpOperator
    comparator_inverse: bool  # the `!`/`not` fused into the operator (e.g. !=)
    compare_with: Optional[LetValue] = None
    custom_message: Optional[str] = None
    location: FileLocation = field(default_factory=FileLocation)


@dataclass
class GuardAccessClause:
    """exprs.rs:177-181."""

    access_clause: AccessClause
    negation: bool = False

    def display(self) -> str:
        # exprs.rs:332-359: GuardAccessClause renders "{not|} {clause}"
        # (leading space when not negated) and AccessClause renders
        # "{query} {display_comparator}{rhs}" where display_comparator
        # carries a trailing space — hence the double space before the
        # RHS and the trailing spaces on unary clauses. Reports pin
        # these strings byte-for-byte.
        ac = self.access_clause
        lead = "not" if self.negation else ""
        cmp_not = "not " if ac.comparator_inverse else ""
        rhs = display_let_value(ac.compare_with) if ac.compare_with is not None else ""
        return f"{lead} {ac.query.display()} {cmp_not}{ac.comparator.display()}  {rhs}"


@dataclass
class MapKeyFilterClause:
    """exprs.rs:183-187."""

    comparator: CmpOperator
    comparator_inverse: bool
    compare_with: LetValue


@dataclass
class GuardNamedRuleClause:
    """Reference to another named rule (exprs.rs:189-195)."""

    dependent_rule: str
    negation: bool = False
    custom_message: Optional[str] = None
    location: FileLocation = field(default_factory=FileLocation)

    def display(self) -> str:
        return f"{'not ' if self.negation else ''}{self.dependent_rule}"


@dataclass
class Block:
    """exprs.rs:242-246."""

    assignments: List[LetExpr]
    conjunctions: "Conjunctions"


@dataclass
class BlockGuardClause:
    """`query { clauses }` (exprs.rs:197-203)."""

    query: AccessQuery
    block: Block
    location: FileLocation = field(default_factory=FileLocation)
    not_empty: bool = False


@dataclass
class ParameterizedNamedRuleClause:
    """`rule_name(arg1, arg2)` call (exprs.rs:211-215)."""

    parameters: List[LetValue]
    named_rule: GuardNamedRuleClause


@dataclass
class WhenBlockClause:
    """`when <conds> { ... }` inside a rule/block (exprs.rs:230)."""

    conditions: "Conjunctions"  # Conjunctions[GuardClause-like when clauses]
    block: Block


# GuardClause = GuardAccessClause | GuardNamedRuleClause
#             | ParameterizedNamedRuleClause | BlockGuardClause | WhenBlockClause
GuardClause = Union[
    GuardAccessClause,
    GuardNamedRuleClause,
    ParameterizedNamedRuleClause,
    BlockGuardClause,
    WhenBlockClause,
]

# Conjunctions<T> = Vec<Vec<T>> — CNF: AND over the outer list, OR inner
Conjunctions = List[List[GuardClause]]


@dataclass
class TypeBlock:
    """`AWS::X::Y { ... }` — sugar for Resources.*[ Type == 'AWS::X::Y' ]
    (exprs.rs:249-254, query construction parser.rs:1622-1656)."""

    type_name: str
    block: Block
    query: List[QueryPart]
    conditions: Optional[Conjunctions] = None


# RuleClause = GuardClause | WhenBlockClause | TypeBlock (exprs.rs:257-261)
RuleClause = Union[GuardClause, TypeBlock]


@dataclass
class Rule:
    """Named rule block (exprs.rs:264-268)."""

    rule_name: str
    conditions: Optional[Conjunctions]
    block: Block


@dataclass
class ParameterizedRule:
    """exprs.rs:271-274."""

    parameter_names: List[str]
    rule: Rule


@dataclass
class RulesFile:
    """exprs.rs:277-284."""

    assignments: List[LetExpr]
    guard_rules: List[Rule]
    parameterized_rules: List[ParameterizedRule]


def walk_expr_tree(obj, visit) -> None:
    """Generic structural walk over the parsed AST: calls
    `visit(node)` on every object reached through dataclass fields,
    lists, tuples and dict values; `visit` returning True stops
    descent below that node. PVs never contain AST nodes, so the walk
    stops there; an id-based seen set makes shared subobjects safe.
    Being structural (not channel-enumerated), new syntax cannot be
    silently missed by consumers like ir._referenced_variable_names
    and fnvars._excluded_fn_vars."""
    import dataclasses as _dc

    from .values import PV

    seen = set()

    def walk(o) -> None:
        if isinstance(o, (str, bytes, int, float, bool)) or o is None:
            return
        if id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, PV):
            return
        if visit(o):
            return
        if _dc.is_dataclass(o) and not isinstance(o, type):
            for f in _dc.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (list, tuple)):
            for e in o:
                walk(e)
        elif isinstance(o, dict):
            for e in o.values():
                walk(e)

    walk(obj)
