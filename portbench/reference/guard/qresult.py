"""Query results and the tri-state evaluation status.

Mirrors `guard/src/rules/mod.rs`:
`Status` (mod.rs:88-133), `QueryResult::{Literal,Resolved,UnResolved}`
(mod.rs:172-177) and `UnResolved{traversed_to, remaining_query, reason}`
(mod.rs:166-170). UnResolved values never abort evaluation — they FAIL
(or SKIP) the owning clause with a retained reason.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

from .values import PV


class Status(str, Enum):
    PASS = "PASS"
    FAIL = "FAIL"
    SKIP = "SKIP"

    def and_(self, other: "Status") -> "Status":
        """mod.rs:122-133."""
        if self == Status.FAIL:
            return Status.FAIL
        if self == Status.PASS:
            return Status.FAIL if other == Status.FAIL else Status.PASS
        return other


LITERAL = 0
RESOLVED = 1
UNRESOLVED = 2


class UnResolved:
    """mod.rs:166-170."""

    __slots__ = ("traversed_to", "remaining_query", "reason")

    def __init__(self, traversed_to: PV, remaining_query: str, reason: Optional[str]):
        self.traversed_to = traversed_to
        self.remaining_query = remaining_query
        self.reason = reason

    def __repr__(self):
        return (
            f"UnResolved(at={self.traversed_to.self_path().s!r}, "
            f"remaining={self.remaining_query!r})"
        )


class QueryResult:
    """Tagged union: Literal | Resolved (both carry a PV) | UnResolved."""

    __slots__ = ("tag", "value", "unresolved")

    def __init__(self, tag: int, value: Optional[PV] = None, unresolved: Optional[UnResolved] = None):
        self.tag = tag
        self.value = value
        self.unresolved = unresolved

    @staticmethod
    def literal(value: PV) -> "QueryResult":
        return QueryResult(LITERAL, value=value)

    @staticmethod
    def resolved(value: PV) -> "QueryResult":
        return QueryResult(RESOLVED, value=value)

    @staticmethod
    def unresolved_(ur: UnResolved) -> "QueryResult":
        return QueryResult(UNRESOLVED, unresolved=ur)

    def is_unresolved(self) -> bool:
        return self.tag == UNRESOLVED

    def resolved_value(self) -> Optional[PV]:
        """mod.rs:180-185 (resolved())."""
        return self.value if self.tag == RESOLVED else None

    def any_value(self) -> Optional[PV]:
        return self.value if self.tag != UNRESOLVED else None

    def __repr__(self):
        if self.tag == UNRESOLVED:
            return f"QR({self.unresolved!r})"
        return f"QR({'lit' if self.tag == LITERAL else 'res'}:{self.value!r})"
