"""Error types for the guard-tpu engine.

Mirrors the error taxonomy of the reference implementation
(`guard/src/rules/errors.rs:11-54`) with the subset that
carries evaluation semantics: parse errors, retrieval errors and
non-comparability (the latter two drive UnResolved / FAIL outcomes in the
evaluator rather than aborting it).
"""

from __future__ import annotations


class GuardError(Exception):
    """Base class for all engine errors (errors.rs:11)."""


class ParseError(GuardError):
    """Rule-file or data-file parse failure (errors.rs ParseError)."""


class RetrievalError(GuardError):
    """A query traversal failed hard (errors.rs RetrievalError)."""


class IncompatibleRetrievalError(GuardError):
    """Traversal hit a node of the wrong shape (errors.rs:~)."""


class NotComparableError(GuardError):
    """Two values cannot be ordered/compared (errors.rs NotComparable).

    The evaluator catches this and turns it into a FAIL with a reason,
    mirroring `eval/operators.rs:195-206`.
    """


class MissingValueError(GuardError):
    """A named rule / variable / parameterized rule was not found."""


class MultipleValuesError(GuardError):
    """Input-parameter merge found a duplicate key (path_value.rs:897)."""


class IncompatibleError(GuardError):
    """Catch-all semantic incompatibility (errors.rs IncompatibleError)."""


class InternalError(GuardError):
    """Invariant violation inside the engine."""
