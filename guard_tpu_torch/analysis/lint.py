"""Guard rule linter: abstract-domain checks over parsed rules.

Finds rules that are statically broken — they can never pass, never
fire, or silently shadow each other — before any document is read:

  unsat-conjunction      ERROR    AND-ed comparisons on one query path
                                  with an empty intersection (interval
                                  analysis on numerics, equality
                                  conflicts on strings)
  type-conflict          ERROR    two different `IS <type>` assertions
                                  AND-ed on one query path
  always-skip-when       WARNING  a `when` gate (or `rule X when ...`
                                  condition) that is statically
                                  unsatisfiable — the guarded block is
                                  dead and the rule always SKIPs
  unsat-filter           WARNING  a `[ ... ]` filter whose predicate
                                  set is unsatisfiable — it selects
                                  nothing, so the query always misses
  shadowed-rule          WARNING  two rules with one name but different
                                  bodies in one file (the name group
                                  merges them; which status wins is an
                                  evaluation-order accident)
  duplicate-rule         WARNING  two byte-equivalent rules under one
                                  name in one file (evaluated twice)
  cross-file-duplicate   INFO     one rule name defined in several
                                  linted files (named-rule references
                                  resolve per file — easy to misread)
  unreferenced-variable  WARNING  a `let` binding never referenced as
                                  `%name` anywhere in its file

The analysis is deliberately conservative — `some`-quantified, negated
and inverse-comparator clauses never contribute constraints — so a
finding is a real property of the rule text, not a heuristic: the
shipped corpora must lint clean at ERROR severity
(tests/test_lint_corpus.py) and stay clean.

Severity contract (the `guard-tpu lint` exit codes build on it):
ERROR = the rule cannot work as written; WARNING = the rule works but
almost certainly not as intended; INFO = worth a look.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import values as _v
from ..core.exprs import (
    BlockGuardClause,
    CmpOperator,
    FileLocation,
    GuardAccessClause,
    LetExpr,
    QFilter,
    QKey,
    Rule,
    RulesFile,
    TypeBlock,
    WhenBlockClause,
    walk_expr_tree,
)
from ..core.values import PV
from ..utils.telemetry import span as _span
from . import ANALYSIS_COUNTERS

ERROR = "ERROR"
WARNING = "WARNING"
INFO = "INFO"
SEVERITIES = (ERROR, WARNING, INFO)
_SEV_RANK = {ERROR: 0, WARNING: 1, INFO: 2}

#: every check code the linter can emit (docs + tests enumerate)
CHECKS = (
    "unsat-conjunction",
    "type-conflict",
    "always-skip-when",
    "unsat-filter",
    "shadowed-rule",
    "duplicate-rule",
    "cross-file-duplicate",
    "unreferenced-variable",
)


@dataclass
class Finding:
    severity: str
    code: str
    message: str
    file: str = ""
    rule: str = ""
    line: int = 0
    column: int = 0

    def render(self) -> str:
        where = f"{self.file}:{self.line}:{self.column}"
        rule = f" (rule {self.rule})" if self.rule else ""
        return f"{where}: {self.severity} [{self.code}]{rule} {self.message}"

    def to_json(self) -> dict:
        return {
            "severity": self.severity,
            "code": self.code,
            "file": self.file,
            "rule": self.rule,
            "line": self.line,
            "column": self.column,
            "message": self.message,
        }


def max_severity(findings: List[Finding]) -> Optional[str]:
    if not findings:
        return None
    return min((f.severity for f in findings), key=_SEV_RANK.get)


# ---------------------------------------------------------------------------
# the abstract numeric/string domain for one (context, query path)
# ---------------------------------------------------------------------------
class _PathDomain:
    """Constraints accumulated for one query path inside one AND
    context: a numeric interval (ints and floats merged — if the
    numeric intersection is empty, no value of either kind satisfies
    the conjunction), string equalities, and `IS <type>` assertions."""

    __slots__ = ("lo", "lo_strict", "hi", "hi_strict", "num_eq",
                 "str_eq", "is_types", "first_loc")

    def __init__(self) -> None:
        self.lo: Optional[float] = None
        self.lo_strict = False
        self.hi: Optional[float] = None
        self.hi_strict = False
        self.num_eq: Optional[float] = None
        self.str_eq: Optional[str] = None
        self.is_types: Dict[str, FileLocation] = {}
        self.first_loc: Optional[FileLocation] = None

    def add_bound(self, op: CmpOperator, val: float) -> Optional[str]:
        """Fold one comparison in; returns an unsat description when
        the interval just became empty."""
        if op is CmpOperator.Eq:
            if self.num_eq is not None and self.num_eq != val:
                return f"== {_fmt(self.num_eq)} conflicts with == {_fmt(val)}"
            self.num_eq = val
        elif op in (CmpOperator.Gt, CmpOperator.Ge):
            strict = op is CmpOperator.Gt
            if self.lo is None or val > self.lo or (
                val == self.lo and strict and not self.lo_strict
            ):
                self.lo, self.lo_strict = val, strict
        elif op in (CmpOperator.Lt, CmpOperator.Le):
            strict = op is CmpOperator.Lt
            if self.hi is None or val < self.hi or (
                val == self.hi and strict and not self.hi_strict
            ):
                self.hi, self.hi_strict = val, strict
        return self._num_unsat()

    def _num_unsat(self) -> Optional[str]:
        lo, hi = self.lo, self.hi
        if lo is not None and hi is not None:
            if lo > hi or (lo == hi and (self.lo_strict or self.hi_strict)):
                return (
                    f"{'>' if self.lo_strict else '>='} {_fmt(lo)} "
                    f"conflicts with "
                    f"{'<' if self.hi_strict else '<='} {_fmt(hi)}"
                )
        if self.num_eq is not None:
            v = self.num_eq
            if lo is not None and (v < lo or (v == lo and self.lo_strict)):
                return (f"== {_fmt(v)} conflicts with "
                        f"{'>' if self.lo_strict else '>='} {_fmt(lo)}")
            if hi is not None and (v > hi or (v == hi and self.hi_strict)):
                return (f"== {_fmt(v)} conflicts with "
                        f"{'<' if self.hi_strict else '<='} {_fmt(hi)}")
        return None

    def add_str_eq(self, val: str) -> Optional[str]:
        if self.str_eq is not None and self.str_eq != val:
            return f"== {self.str_eq!r} conflicts with == {val!r}"
        self.str_eq = val
        return None

    def add_is_type(self, op: CmpOperator, loc: FileLocation) -> Optional[str]:
        self.is_types[op.value] = loc
        if len(self.is_types) > 1:
            return " and ".join(sorted(self.is_types))
        return None


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


_IS_TYPES = {
    CmpOperator.IsString,
    CmpOperator.IsList,
    CmpOperator.IsMap,
    CmpOperator.IsBool,
    CmpOperator.IsInt,
    CmpOperator.IsFloat,
    CmpOperator.IsNull,
}


# ---------------------------------------------------------------------------
# AND-context collection
# ---------------------------------------------------------------------------
def _contexts(rule: Rule):
    """Yield every AND context in a rule as (kind, conjunctions) with
    kind 'when' (a gate: unsat = dead block), 'filter' (a selection:
    unsat = empty selection) or 'clauses' (assertions: unsat = the
    rule can never pass). Conjunctions are CNF — outer AND, inner OR —
    so only single-clause disjunctions contribute constraints."""
    if rule.conditions:
        yield ("when", rule.conditions)
    stack: List[Tuple[str, list]] = [("clauses", rule.block.conjunctions)]
    while stack:
        kind, conjs = stack.pop()
        yield (kind, conjs)
        for disj in conjs:
            for clause in disj:
                if isinstance(clause, BlockGuardClause):
                    stack.append(("clauses", clause.block.conjunctions))
                    _push_filters(clause.query.query, stack)
                elif isinstance(clause, WhenBlockClause):
                    stack.append(("when", clause.conditions))
                    stack.append(("clauses", clause.block.conjunctions))
                elif isinstance(clause, TypeBlock):
                    stack.append(("clauses", clause.block.conjunctions))
                    if clause.conditions:
                        stack.append(("when", clause.conditions))
                elif isinstance(clause, GuardAccessClause):
                    _push_filters(clause.access_clause.query.query, stack)


def _push_filters(parts: List, stack: List) -> None:
    for p in parts:
        if isinstance(p, QFilter):
            stack.append(("filter", p.conjunctions))


def _clause_loc(clause) -> FileLocation:
    if isinstance(clause, GuardAccessClause):
        return clause.access_clause.location
    return FileLocation()


def _check_context(
    kind: str, conjs, rule_name: str, file_name: str
) -> List[Finding]:
    """The unsat/type-conflict pass over one AND context."""
    out: List[Finding] = []
    domains: Dict[str, _PathDomain] = {}
    reported: set = set()

    def emit(code: str, sev: str, msg: str, loc: FileLocation) -> None:
        key = (code, rule_name, msg)
        if key in reported:
            return
        reported.add(key)
        out.append(Finding(
            severity=sev, code=code, message=msg, file=file_name,
            rule=rule_name, line=loc.line, column=loc.column,
        ))

    def conflict(detail: str, path: str, loc: FileLocation,
                 type_conflict: bool = False) -> None:
        if type_conflict:
            emit("type-conflict", ERROR,
                 f"`{path}` is asserted to be {detail} on one path — "
                 "the conjunction can never hold", loc)
        elif kind == "when":
            emit("always-skip-when", WARNING,
                 f"when gate is statically unsatisfiable on `{path}`: "
                 f"{detail} — the guarded block is dead (always SKIP)",
                 loc)
        elif kind == "filter":
            emit("unsat-filter", WARNING,
                 f"filter predicate on `{path}` is unsatisfiable: "
                 f"{detail} — the filter selects nothing", loc)
        else:
            emit("unsat-conjunction", ERROR,
                 f"AND-ed comparisons on `{path}` are unsatisfiable: "
                 f"{detail}", loc)

    for disj in conjs:
        if len(disj) != 1 or not isinstance(disj[0], GuardAccessClause):
            continue  # OR'd or non-access clauses add no constraint
        clause = disj[0]
        ac = clause.access_clause
        if clause.negation or ac.comparator_inverse or not ac.query.match_all:
            continue  # negations and `some` never make a conjunction unsat
        path = ac.query.display()
        dom = domains.get(path)
        if dom is None:
            dom = domains[path] = _PathDomain()
            dom.first_loc = ac.location
        op = ac.comparator
        if op in _IS_TYPES:
            detail = dom.add_is_type(op, ac.location)
            if detail:
                conflict(detail, path, ac.location, type_conflict=True)
            continue
        rhs = ac.compare_with
        if not isinstance(rhs, PV):
            continue
        if op is CmpOperator.Eq and rhs.kind == _v.STRING:
            detail = dom.add_str_eq(rhs.val)
            if detail:
                conflict(detail, path, ac.location)
        elif (
            op in (CmpOperator.Eq, CmpOperator.Gt, CmpOperator.Ge,
                   CmpOperator.Lt, CmpOperator.Le)
            and rhs.kind in (_v.INT, _v.FLOAT)
        ):
            detail = dom.add_bound(op, rhs.val)
            if detail:
                conflict(detail, path, ac.location)
    return out


# ---------------------------------------------------------------------------
# duplicate / shadowed rules
# ---------------------------------------------------------------------------
def _canon(obj):
    """Location-insensitive structural fingerprint of an AST subtree
    (PVs canonicalize through their display form — they carry no
    dataclass fields to compare)."""
    if isinstance(obj, FileLocation):
        return "@"
    if isinstance(obj, PV):
        from ..core.values import rust_debug_pv

        return ("pv", rust_debug_pv(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            _canon(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(e) for e in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _canon(v)) for k, v in obj.items()))
    return obj


def _check_duplicates(rf: RulesFile, file_name: str) -> List[Finding]:
    out: List[Finding] = []
    by_name: Dict[str, List[Rule]] = {}
    for r in rf.guard_rules:
        by_name.setdefault(r.rule_name, []).append(r)
    for name, rules in by_name.items():
        if len(rules) < 2:
            continue
        canons = [_canon(r) for r in rules]
        if all(c == canons[0] for c in canons[1:]):
            out.append(Finding(
                severity=WARNING, code="duplicate-rule", file=file_name,
                rule=name,
                message=f"rule `{name}` is defined {len(rules)} times "
                "with identical bodies — the name group evaluates the "
                "same assertions repeatedly",
            ))
        else:
            out.append(Finding(
                severity=WARNING, code="shadowed-rule", file=file_name,
                rule=name,
                message=f"rule `{name}` is defined {len(rules)} times "
                "with DIFFERENT bodies — same-named rules merge into "
                "one name group, so which status wins is an "
                "evaluation-order accident",
            ))
    return out


# ---------------------------------------------------------------------------
# unreferenced variables
# ---------------------------------------------------------------------------
def _check_variables(rf: RulesFile, file_name: str) -> List[Finding]:
    declared: Dict[str, str] = {}  # var -> owning rule name ("" = file)
    for let in rf.assignments:
        declared.setdefault(let.var, "")

    def collect_lets(rule: Rule) -> None:
        def visit(node) -> bool:
            if isinstance(node, LetExpr):
                declared.setdefault(node.var, rule.rule_name)
            return False

        walk_expr_tree(rule, visit)

    params: set = set()
    for r in rf.guard_rules:
        collect_lets(r)
    for pr in rf.parameterized_rules:
        params.update(pr.parameter_names)
        collect_lets(pr.rule)

    referenced: set = set()

    def visit_ref(node) -> bool:
        if isinstance(node, QKey) and node.name.startswith("%"):
            referenced.add(node.name[1:])
        return False

    walk_expr_tree(rf, visit_ref)

    out: List[Finding] = []
    for var, owner in sorted(declared.items()):
        if var in referenced or var in params:
            continue
        where = f"rule `{owner}`" if owner else "file scope"
        out.append(Finding(
            severity=WARNING, code="unreferenced-variable",
            file=file_name, rule=owner,
            message=f"`let {var}` ({where}) is never referenced as "
            f"`%{var}`",
        ))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def lint_rules_file(rf: RulesFile, file_name: str) -> List[Finding]:
    """All single-file checks over one parsed rules file."""
    out: List[Finding] = []
    rules = list(rf.guard_rules)
    rules.extend(pr.rule for pr in rf.parameterized_rules)
    for rule in rules:
        for kind, conjs in _contexts(rule):
            out.extend(_check_context(kind, conjs, rule.rule_name,
                                      file_name))
    out.extend(_check_duplicates(rf, file_name))
    out.extend(_check_variables(rf, file_name))
    return out


def lint_files(parsed: List[Tuple[str, RulesFile]]) -> List[Finding]:
    """Lint a set of (file name, parsed file) pairs: per-file checks
    plus the cross-file duplicate-name pass. Findings sort by file,
    then severity."""
    with _span("lint", {"files": len(parsed)}):
        out: List[Finding] = []
        defined: Dict[str, List[str]] = {}
        for name, rf in parsed:
            out.extend(lint_rules_file(rf, name))
            for r in rf.guard_rules:
                files = defined.setdefault(r.rule_name, [])
                if name not in files:
                    files.append(name)
        for rule_name, files in sorted(defined.items()):
            if len(files) > 1:
                out.append(Finding(
                    severity=INFO, code="cross-file-duplicate",
                    file=files[0], rule=rule_name,
                    message=f"rule `{rule_name}` is defined in "
                    f"{len(files)} files ({', '.join(files)}) — "
                    "named-rule references resolve within one file "
                    "only",
                ))
        out.sort(key=lambda f: (f.file, _SEV_RANK[f.severity], f.line,
                                f.code))
        ANALYSIS_COUNTERS["lint_findings"] += len(out)
        return out
