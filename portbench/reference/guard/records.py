"""Structured evaluation event records.

The evaluator emits a typed event tree — the engine's tracing system and
the contract all reporters consume. Mirrors the `RecordType` hierarchy of
`guard/src/rules/mod.rs:279-355` and the `EventRecord`
tree built by `RecordTracker` (eval_context.rs:999-1059, 41-45).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .exprs import CmpOperator
from .qresult import QueryResult, Status


@dataclass
class NamedStatus:
    """mod.rs:262-266."""

    name: str
    status: Status
    message: Optional[str] = None


@dataclass
class BlockCheck:
    """mod.rs:255-259."""

    at_least_one_matches: bool
    status: Status
    message: Optional[str] = None


@dataclass
class TypeBlockCheck:
    """mod.rs:249-252."""

    type_name: str
    block: BlockCheck


@dataclass
class ValueCheck:
    """mod.rs:216-221."""

    from_: QueryResult
    status: Status
    message: Optional[str] = None
    custom_message: Optional[str] = None


@dataclass
class UnaryValueCheck:
    """mod.rs:224-227."""

    value: ValueCheck
    comparison: Tuple[CmpOperator, bool]


@dataclass
class ComparisonClauseCheck:
    """mod.rs:196-203."""

    comparison: Tuple[CmpOperator, bool]
    from_: QueryResult
    to: Optional[QueryResult]
    status: Status
    message: Optional[str] = None
    custom_message: Optional[str] = None


@dataclass
class InComparisonCheck:
    """mod.rs:206-213."""

    comparison: Tuple[CmpOperator, bool]
    from_: QueryResult
    to: List[QueryResult]
    status: Status
    message: Optional[str] = None
    custom_message: Optional[str] = None


@dataclass
class MissingValueCheck:
    """mod.rs:230-235."""

    rule: str
    status: Status
    message: Optional[str] = None
    custom_message: Optional[str] = None


# ClauseCheck variants (mod.rs:238-246) — each record carries `kind`
class ClauseCheck:
    SUCCESS = "Success"
    COMPARISON = "Comparison"
    IN_COMPARISON = "InComparison"
    UNARY = "Unary"
    NO_VALUE_FOR_EMPTY = "NoValueForEmptyCheck"
    DEPENDENT_RULE = "DependentRule"
    MISSING_BLOCK_VALUE = "MissingBlockValue"

    def __init__(self, kind: str, payload=None):
        self.kind = kind
        self.payload = payload

    @staticmethod
    def success() -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.SUCCESS)

    @staticmethod
    def comparison(c: ComparisonClauseCheck) -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.COMPARISON, c)

    @staticmethod
    def in_comparison(c: InComparisonCheck) -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.IN_COMPARISON, c)

    @staticmethod
    def unary(c: UnaryValueCheck) -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.UNARY, c)

    @staticmethod
    def no_value_for_empty(custom_message: Optional[str]) -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.NO_VALUE_FOR_EMPTY, custom_message)

    @staticmethod
    def dependent_rule(c: MissingValueCheck) -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.DEPENDENT_RULE, c)

    @staticmethod
    def missing_block_value(c: ValueCheck) -> "ClauseCheck":
        return ClauseCheck(ClauseCheck.MISSING_BLOCK_VALUE, c)

    def status(self) -> Status:
        if self.kind == ClauseCheck.SUCCESS:
            return Status.PASS
        if self.kind == ClauseCheck.NO_VALUE_FOR_EMPTY:
            return Status.FAIL
        if self.kind == ClauseCheck.UNARY:
            return self.payload.value.status
        return self.payload.status

    def custom_message(self) -> Optional[str]:
        if self.kind == ClauseCheck.SUCCESS:
            return None
        if self.kind == ClauseCheck.NO_VALUE_FOR_EMPTY:
            return self.payload
        if self.kind == ClauseCheck.UNARY:
            return self.payload.value.custom_message
        return self.payload.custom_message


class RecordType:
    """Tagged container mirroring mod.rs:279-355."""

    FILE_CHECK = "FileCheck"
    RULE_CHECK = "RuleCheck"
    RULE_CONDITION = "RuleCondition"
    TYPE_CHECK = "TypeCheck"
    TYPE_CONDITION = "TypeCondition"
    TYPE_BLOCK = "TypeBlock"
    FILTER = "Filter"
    WHEN_CHECK = "WhenCheck"
    WHEN_CONDITION = "WhenCondition"
    DISJUNCTION = "Disjunction"
    BLOCK_GUARD_CHECK = "BlockGuardCheck"
    GUARD_CLAUSE_BLOCK_CHECK = "GuardClauseBlockCheck"
    CLAUSE_VALUE_CHECK = "ClauseValueCheck"

    __slots__ = ("kind", "payload")

    def __init__(self, kind: str, payload):
        self.kind = kind
        self.payload = payload

    def status(self) -> Optional[Status]:
        k = self.kind
        if k in (RecordType.FILE_CHECK, RecordType.RULE_CHECK):
            return self.payload.status
        if k in (
            RecordType.RULE_CONDITION,
            RecordType.TYPE_CONDITION,
            RecordType.TYPE_BLOCK,
            RecordType.FILTER,
            RecordType.WHEN_CONDITION,
        ):
            return self.payload
        if k == RecordType.TYPE_CHECK:
            return self.payload.block.status
        if k in (
            RecordType.WHEN_CHECK,
            RecordType.DISJUNCTION,
            RecordType.BLOCK_GUARD_CHECK,
            RecordType.GUARD_CLAUSE_BLOCK_CHECK,
        ):
            return self.payload.status
        if k == RecordType.CLAUSE_VALUE_CHECK:
            return self.payload.status()
        return None


@dataclass
class EventRecord:
    """eval_context.rs:41-45."""

    context: str
    container: Optional[RecordType] = None
    children: List["EventRecord"] = field(default_factory=list)
