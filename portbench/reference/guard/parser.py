"""Guard DSL parser.

Hand-written recursive-descent parser that mirrors, production for
production, the nom combinator grammar of the reference
(`guard/src/rules/parser.rs`): scalar/range/regex/list/map
literals (parser.rs:167-425), access queries with filters and projections
(parser.rs:718-951), clauses with CNF or-joins (parser.rs:1180-1412),
blocks / named rules / parameterized rules / type blocks
(parser.rs:1510-1790) and the top-level rules-file assembly with the
synthesized `default` rule (parser.rs:1840-1932).

Backtracking model: `Backtrack` is nom's recoverable `Err::Error` (alt
tries the next branch); `Fatal` is `Err::Failure` (a `cut` — no
backtracking, surfaces as a ParseError to the caller).
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, List, Optional, Tuple

from .errors import ParseError
from .exprs import (
    AccessClause,
    AccessQuery,
    Block,
    BlockGuardClause,
    CmpOperator,
    Conjunctions,
    FileLocation,
    FunctionExpr,
    GuardAccessClause,
    GuardNamedRuleClause,
    LetExpr,
    MapKeyFilterClause,
    ParameterizedNamedRuleClause,
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
    TypeBlock,
    WhenBlockClause,
    part_is_variable,
)
from .functions import FUNCTION_ARITY
from .values import (
    LOWER_INCLUSIVE,
    RANGE_CHAR,
    RANGE_FLOAT,
    RANGE_INT,
    UPPER_INCLUSIVE,
    MapValue,
    Path,
    PV,
    Range,
    compiled_regex,
)

DEFAULT_RULE_NAME = "default"  # parser.rs:33


class Backtrack(Exception):
    """Recoverable parse error (nom Err::Error)."""

    def __init__(self, pos: int, context: str = ""):
        self.pos = pos
        self.context = context
        super().__init__(context)


class Fatal(Exception):
    """Unrecoverable parse error (nom Err::Failure / cut)."""

    def __init__(self, pos: int, context: str = ""):
        self.pos = pos
        self.context = context
        super().__init__(context)


_VAR_NAME_RE = re.compile(r"[A-Za-z][A-Za-z0-9_]*")
_KEY_CHARS_RE = re.compile(r"[A-Za-z0-9_-]+")
_INT_RE = re.compile(r"[0-9]+")
# the GATE mirrors parser.rs:230-243: fraction, or exponent WITH a
# sign; on success the reference re-parses with nom's `double`, whose
# grammar also takes an UNSIGNED exponent — so `1.5e3` is a float but
# `2e3` is not (gate fails: no fraction, no signed exponent)
_FLOAT_BODY_RE = re.compile(r"[0-9]+(\.[0-9]+)?([eE][+-][0-9]+)?")
_FLOAT_DOUBLE_RE = re.compile(r"[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?")


class Parser:
    def __init__(self, text: str, file_name: str = ""):
        self.text = text
        self.n = len(text)
        self.pos = 0
        self.file_name = file_name
        # line-start offsets for location computation
        self._line_starts = [0]
        for m in re.finditer("\n", text):
            self._line_starts.append(m.end())

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------
    def loc(self, pos: Optional[int] = None) -> FileLocation:
        p = self.pos if pos is None else pos
        line_idx = bisect.bisect_right(self._line_starts, p) - 1
        return FileLocation(
            line=line_idx + 1,
            column=p - self._line_starts[line_idx] + 1,
            file_name=self.file_name,
        )

    def eof(self) -> bool:
        return self.pos >= self.n

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def tag(self, s: str) -> None:
        if self.text.startswith(s, self.pos):
            self.pos += len(s)
            return
        raise Backtrack(self.pos, f"expected {s!r}")

    def char(self, c: str) -> None:
        if self.pos < self.n and self.text[self.pos] == c:
            self.pos += 1
            return
        raise Backtrack(self.pos, f"expected {c!r}")

    def try_tag(self, s: str) -> bool:
        if self.text.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def regex(self, rx) -> str:
        m = rx.match(self.text, self.pos)
        if not m:
            raise Backtrack(self.pos)
        self.pos = m.end()
        return m.group(0)

    # ws / comments ----------------------------------------------------
    def skip_ws(self) -> None:
        """zero_or_more_ws_or_comment (parser.rs:139-141)."""
        t, n = self.text, self.n
        p = self.pos
        while p < n:
            c = t[p]
            if c in " \t\r\n":
                p += 1
            elif c == "#":
                nl = t.find("\n", p)
                p = n if nl < 0 else nl + 1
            else:
                break
        self.pos = p

    def skip_ws1(self) -> None:
        """one_or_more_ws_or_comment (parser.rs:131-133)."""
        start = self.pos
        self.skip_ws()
        if self.pos == start:
            raise Backtrack(self.pos, "expected whitespace or comment")

    def skip_space0(self) -> None:
        while self.pos < self.n and self.text[self.pos] in " \t":
            self.pos += 1

    def space1(self) -> None:
        if self.pos < self.n and self.text[self.pos] in " \t":
            self.skip_space0()
            return
        raise Backtrack(self.pos, "expected space")

    def alt(self, *parsers):
        """nom alt: try in order, backtracking on Backtrack only."""
        start = self.pos
        last = None
        for p in parsers:
            try:
                return p()
            except Backtrack as e:
                self.pos = start
                last = e
        raise last if last is not None else Backtrack(start)

    def opt(self, parser):
        start = self.pos
        try:
            return parser()
        except Backtrack:
            self.pos = start
            return None

    def cut(self, parser, context: str = ""):
        try:
            return parser()
        except Backtrack as e:
            raise Fatal(e.pos, context or e.context)

    # ------------------------------------------------------------------
    # value literals (parser.rs:167-425)
    # ------------------------------------------------------------------
    def var_name(self) -> str:
        """parser.rs:545-551."""
        return self.regex(_VAR_NAME_RE)

    def var_name_access(self) -> str:
        self.char("%")
        return self.var_name()

    def parse_string(self) -> str:
        """Single or double quoted with backslash-escape of the quote
        (parser.rs:177-208)."""
        q = self.peek()
        if q not in ("'", '"'):
            raise Backtrack(self.pos, "expected string")
        self.pos += 1
        out = []
        t = self.text
        while True:
            end = t.find(q, self.pos)
            if end < 0:
                raise Fatal(self.pos, "unterminated string")
            frag = t[self.pos : end]
            if frag.endswith("\\"):
                out.append(frag[:-1])
                out.append(q)
                self.pos = end + 1
                continue
            out.append(frag)
            self.pos = end + 1
            return "".join(out)

    def parse_int_scalar(self) -> int:
        """parser.rs:167-175 (note: negative branch is tried second)."""
        if self.try_tag("-"):
            return -int(self.regex(_INT_RE))
        return int(self.regex(_INT_RE))

    def parse_float_scalar(self) -> float:
        """parser.rs:230-243 — the gate requires a fraction or a
        SIGNED exponent, then nom `double` consumes the maximal float
        (incl. an unsigned exponent after a fraction: `1.5e3`)."""
        m = _FLOAT_BODY_RE.match(self.text, self.pos)
        if not m or (m.group(1) is None and m.group(2) is None):
            raise Backtrack(self.pos, "not a float")
        m2 = _FLOAT_DOUBLE_RE.match(self.text, self.pos)
        self.pos = m2.end()
        return float(m2.group(0))

    def parse_regex_literal(self) -> str:
        """parser.rs:245-286 — /.../ with \\/ escapes; validated."""
        self.char("/")
        out = []
        t = self.text
        while True:
            end = t.find("/", self.pos)
            if end < 0:
                raise Backtrack(self.pos, "unterminated regex")
            frag = t[self.pos : end]
            if frag.endswith("\\"):
                out.append(frag[:-1])
                out.append("/")
                self.pos = end + 1
                continue
            out.append(frag)
            self.pos = end + 1
            pattern = "".join(out)
            try:
                compiled_regex(pattern)
            except re.error as e:
                raise Backtrack(self.pos, f"Could not parse regular expression: {e}")
            return pattern

    def parse_scalar_value(self) -> PV:
        """parser.rs:345-357 — order matters: string, float, int, bool, regex."""
        start = self.pos
        p = Path.root()
        try:
            return PV.string(p, self.parse_string())
        except Backtrack:
            self.pos = start
        try:
            return PV.float_(p, self.parse_float_scalar())
        except Backtrack:
            self.pos = start
        try:
            return PV.int_(p, self.parse_int_scalar())
        except Backtrack:
            self.pos = start
        for lit, val in (("true", True), ("True", True), ("false", False), ("False", False)):
            if self.try_tag(lit):
                return PV.boolean(p, val)
        try:
            return PV.regex(p, self.parse_regex_literal())
        except Backtrack:
            self.pos = start
        raise Backtrack(self.pos, "expected scalar value")

    def parse_range(self) -> PV:
        """parser.rs:292-340: r[lo, hi) etc."""
        p = Path.root()
        self.char("r")
        open_c = self.peek()
        if open_c not in "([":
            raise Backtrack(self.pos, "expected ( or [")
        self.pos += 1

        def range_endpoint():
            self.skip_space0()
            v = self.alt(
                lambda: ("f", self.parse_float_scalar()),
                lambda: ("i", self.parse_int_scalar()),
                lambda: ("c", self._any_char()),
            )
            self.skip_space0()
            return v

        (k1, lo) = range_endpoint()
        self.char(",")
        (k2, hi) = range_endpoint()
        close_c = self.peek()
        if close_c not in ")]":
            raise Backtrack(self.pos, "expected ) or ]")
        self.pos += 1
        inclusive = (LOWER_INCLUSIVE if open_c == "[" else 0) | (
            UPPER_INCLUSIVE if close_c == "]" else 0
        )
        if k1 == "i" and k2 == "i":
            return PV(p, RANGE_INT, Range(lo, hi, inclusive))
        if k1 == "f" and k2 == "f":
            return PV(p, RANGE_FLOAT, Range(lo, hi, inclusive))
        if k1 == "c" and k2 == "c":
            return PV(p, RANGE_CHAR, Range(lo, hi, inclusive))
        raise Fatal(self.pos, "Could not parse range")

    def _any_char(self) -> str:
        if self.eof():
            raise Backtrack(self.pos)
        c = self.text[self.pos]
        self.pos += 1
        return c

    def parse_list_literal(self) -> PV:
        """parser.rs:363-372."""
        self.skip_ws()
        self.char("[")
        items: List[PV] = []
        while True:
            start = self.pos
            try:
                items.append(self.parse_value())
            except Backtrack:
                self.pos = start
                break
            save = self.pos
            self.skip_ws()
            if not self.try_tag(","):
                self.pos = save
                break
        self.skip_ws()
        self.char("]")
        return PV.list_(Path.root(), items)

    def _key_part(self) -> str:
        """parser.rs:374-388."""
        start = self.pos
        m = _KEY_CHARS_RE.match(self.text, self.pos)
        if m:
            self.pos = m.end()
            return m.group(0)
        self.pos = start
        return self.parse_string()

    def parse_map_literal(self) -> PV:
        """parser.rs:390-408."""
        self.char("{")
        mv = MapValue()
        first = True
        while True:
            save = self.pos
            try:
                self.skip_ws()
                key = self._key_part()
                self.skip_ws()
                self.char(":")
                val = self.parse_value()
            except Backtrack:
                self.pos = save
                break
            if key not in mv.values:
                mv.keys.append(PV.string(Path.root(), key))
            mv.values[key] = val
            first = False
            save = self.pos
            self.skip_ws()
            if not self.try_tag(","):
                self.pos = save
                break
        self.skip_ws()
        self.char("}")
        return PV.map_(Path.root(), mv)

    def parse_value(self) -> PV:
        """parser.rs:414-425 (order: null, scalar, range, list, map)."""
        self.skip_ws()
        start = self.pos
        for lit in ("null", "NULL"):
            if self.try_tag(lit):
                return PV.null(Path.root())
        for fn in (self.parse_scalar_value, self.parse_range, self.parse_list_literal, self.parse_map_literal):
            try:
                return fn()
            except Backtrack:
                self.pos = start
        raise Backtrack(self.pos, "expected value")

    # ------------------------------------------------------------------
    # comparison operators (parser.rs:578-694)
    # ------------------------------------------------------------------
    def _not_kw(self) -> bool:
        """parser.rs:582-593: 'not'/'NOT' + space, or '!'. Returns True so
        `opt(_not_kw) is not None` detects presence."""
        start = self.pos
        for kw in ("not", "NOT"):
            if self.try_tag(kw):
                try:
                    self.space1()
                    return True
                except Backtrack:
                    self.pos = start
        self.char("!")
        return True

    _IS_TYPE_OPS = [
        ("IS_STRING", "is_string", CmpOperator.IsString),
        ("IS_LIST", "is_list", CmpOperator.IsList),
        ("IS_STRUCT", "is_struct", CmpOperator.IsMap),
        ("IS_BOOL", "is_bool", CmpOperator.IsBool),
        ("IS_INT", "is_int", CmpOperator.IsInt),
        ("IS_NULL", "is_null", CmpOperator.IsNull),
        ("IS_FLOAT", "is_float", CmpOperator.IsFloat),
    ]

    def value_cmp(self) -> Tuple[CmpOperator, bool]:
        """parser.rs:663-694."""
        # '<<' is the custom-message delimiter, not Lt (parser.rs:669-676)
        if self.text.startswith("<<", self.pos):
            raise Backtrack(self.pos, "custom message tag detected")
        if self.try_tag("=="):
            return (CmpOperator.Eq, False)
        if self.try_tag("!="):
            return (CmpOperator.Eq, True)
        if self.try_tag(">="):
            return (CmpOperator.Ge, False)
        if self.try_tag("<="):
            return (CmpOperator.Le, False)
        if self.try_tag(">"):
            return (CmpOperator.Gt, False)
        if self.try_tag("<"):
            return (CmpOperator.Lt, False)
        # other_operations: opt(not) (in|exists|empty|is_*)
        start = self.pos
        negated = self.opt(self._not_kw) is not None
        for tags, op in (
            (("in", "IN"), CmpOperator.In),
            (("EXISTS", "exists"), CmpOperator.Exists),
            (("EMPTY", "empty"), CmpOperator.Empty),
        ):
            for t in tags:
                if self.try_tag(t):
                    return (op, negated)
        for upper, lower, op in self._IS_TYPE_OPS:
            if self.try_tag(upper) or self.try_tag(lower):
                return (op, negated)
        self.pos = start
        raise Backtrack(self.pos, "expected comparison operator")

    def custom_message(self) -> str:
        """parser.rs:696-712: << ... >>."""
        self.tag("<<")
        end = self.text.find(">>", self.pos)
        if end < 0:
            raise Fatal(self.pos, "Unable to find a closing >> tag for message")
        msg = self.text[self.pos : end]
        self.pos = end + 2
        return msg

    # ------------------------------------------------------------------
    # access queries (parser.rs:718-951)
    # ------------------------------------------------------------------
    def _property_name(self) -> str:
        """parser.rs:879-887: bare name or quoted string."""
        try:
            return self.var_name()
        except Backtrack:
            return self.parse_string()

    def _dotted_property(self):
        """parser.rs:732-751."""
        self.skip_ws()
        self.char(".")
        start = self.pos
        # int index
        try:
            return QIndex(self.parse_int_scalar())
        except Backtrack:
            self.pos = start
        try:
            return QKey(self._property_name())
        except Backtrack:
            self.pos = start
        try:
            return QKey("%" + self.var_name_access())
        except Backtrack:
            self.pos = start
        self.char("*")
        return QAllValues(None)

    def _variable_capture(self) -> str:
        """parser.rs:718-722: `name |` inside [ ]."""
        self.skip_ws()
        name = self.var_name()
        self.skip_space0()
        self.char("|")
        return name

    def _bracket_part(self):
        """predicate_or_index (parser.rs:847-855)."""
        start = self.pos
        # all_indices: [*] or [name] (parser.rs:761-772)
        try:
            self.skip_ws()
            self.char("[")
            try:
                save = self.pos
                self.skip_ws()
                self.char("*")
                part = QAllIndices(None)
            except Backtrack:
                self.pos = save
                part = QAllIndices(self.var_name())
            self.skip_ws()
            self.char("]")
            return part
        except Backtrack:
            self.pos = start
        # array_index: [int] (parser.rs:774-785)
        try:
            self.skip_ws()
            self.char("[")
            idx = self.parse_int_scalar()
            self.cut(lambda: (self.skip_ws(), self.char("]")))
            return QIndex(idx)
        except Backtrack:
            self.pos = start
        # map_key_lookup: ['key'] or [ name ] (parser.rs:787-808)
        try:
            self.skip_ws()
            self.char("[")
            try:
                save = self.pos
                s = self.parse_string()
                part = QKey(s)
            except Backtrack:
                self.pos = save
                self.skip_ws()
                name = self.var_name()
                self.skip_ws()
                part = QAllValues(name)
            self.skip_ws()
            self.char("]")
            return part
        except Backtrack:
            self.pos = start
        # map_keys_match: [ keys == ... ] (parser.rs:810-845)
        try:
            return self._map_keys_match()
        except Backtrack:
            self.pos = start
        # predicate_filter_clauses: [ cnf ] (parser.rs:724-730)
        self.skip_ws()
        self.char("[")
        var = self.opt(self._variable_capture)
        filters = self._cnf_clauses(self.clause)
        self.cut(lambda: (self.skip_ws(), self.char("]")), "expected ]")
        return QFilter(var, filters)

    def _map_keys_match(self):
        self.skip_ws()
        self.char("[")
        var = self.opt(self._variable_capture)
        self.skip_ws()
        if not (self.try_tag("KEYS") or self.try_tag("keys")):
            raise Backtrack(self.pos, "expected keys")

        def cmp_parser():
            self.skip_ws()
            if self.try_tag("=="):
                return (CmpOperator.Eq, False)
            if self.try_tag("!="):
                return (CmpOperator.Eq, True)
            start = self.pos
            try:
                self._not_kw()
                if self.try_tag("in") or self.try_tag("IN"):
                    return (CmpOperator.In, True)
                raise Backtrack(self.pos)
            except Backtrack:
                self.pos = start
            if self.try_tag("in") or self.try_tag("IN"):
                return (CmpOperator.In, False)
            raise Backtrack(self.pos, "expected keys comparator")

        cmp = self.cut(cmp_parser, "expected comparator after keys")

        def with_parser():
            self.skip_ws()
            try:
                return self.parse_value()
            except Backtrack:
                pass
            self.skip_ws()
            return self.access()

        with_val = self.cut(with_parser, "expected RHS for keys filter")
        self.skip_ws()
        self.char("]")
        op, inv = cmp
        return QMapKeyFilter(var, MapKeyFilterClause(op, inv, with_val))

    def _some_keyword(self) -> bool:
        self.skip_ws()
        if self.try_tag("SOME") or self.try_tag("some"):
            self.skip_ws1()
            return True
        raise Backtrack(self.pos)

    def access(self) -> AccessQuery:
        """parser.rs:913-951."""
        some = self.opt(self._some_keyword)
        self.skip_ws()
        # first part: this | %var | property
        start = self.pos
        first = None
        for kw in ("this", "THIS"):
            if self.try_tag(kw):
                first = QThis()
                break
        if first is None:
            try:
                first = QKey("%" + self.var_name_access())
            except Backtrack:
                self.pos = start
                first = QKey(self._property_name())
        rest_start = self.pos
        parts: List = []
        while True:
            save = self.pos
            try:
                parts.append(self.alt(self._dotted_property, self._bracket_part))
            except Backtrack:
                self.pos = save
                break
        if parts:
            parts.insert(0, first)
            # variable first part gets an implicit [*] (parser.rs:926-944)
            if part_is_variable(first):
                if not (len(parts) > 1 and isinstance(parts[1], QAllIndices)):
                    parts.insert(1, QAllIndices(None))
        else:
            self.pos = rest_start
            parts = [first]
        return AccessQuery(query=parts, match_all=some is None)

    # ------------------------------------------------------------------
    # function expressions (parser.rs:1074-1134)
    # ------------------------------------------------------------------
    def _call_expr(self) -> Tuple[str, List]:
        name = self.var_name()
        self.char("(")
        params: List = []
        while True:
            save = self.pos
            try:
                self.skip_ws()
                params.append(self.let_value())
                self.skip_ws()
            except Backtrack:
                self.pos = save
                break
            if not self.try_tag(","):
                break
        self.char(")")
        return name, params

    def function_expr(self) -> FunctionExpr:
        location = self.loc()
        name, params = self._call_expr()
        if name not in FUNCTION_ARITY:
            raise Backtrack(self.pos, f"No function with the name '{name}' exists.")
        if len(params) != FUNCTION_ARITY[name]:
            raise Backtrack(
                self.pos,
                f"function: {name} requires: {FUNCTION_ARITY[name]} parameters to "
                f"be passed, but received: {len(params)}",
            )
        return FunctionExpr(name=name, parameters=params, location=location)

    def let_value(self):
        """parser.rs:1112-1123 (order: value, function, access)."""
        self.skip_ws()
        start = self.pos
        try:
            return self.parse_value()
        except Backtrack:
            self.pos = start
        try:
            return self.function_expr()
        except Backtrack:
            self.pos = start
        return self.access()

    # ------------------------------------------------------------------
    # clauses (parser.rs:954-1198)
    # ------------------------------------------------------------------
    def _access_clause(self, mk) -> object:
        """clause_with_map (parser.rs:954-1038)."""
        self.skip_ws()
        location = self.loc()
        negation = self.opt(self._not_kw) is not None
        query = self.access()
        self.skip_ws()
        cmp = self.value_cmp()
        op, inverse = cmp
        if op.is_unary():
            save = self.pos
            self.skip_ws()
            msg = self.opt(self.custom_message)
            if msg is None:
                self.pos = save
            return mk(
                GuardAccessClause(
                    access_clause=AccessClause(
                        query=query,
                        comparator=op,
                        comparator_inverse=inverse,
                        compare_with=None,
                        custom_message=msg,
                        location=location,
                    ),
                    negation=negation,
                )
            )

        def rhs():
            start = self.pos
            try:
                v = self.parse_value()
            except Backtrack:
                self.pos = start
                try:
                    self.skip_ws()
                    v = self.function_expr()
                except Backtrack:
                    self.pos = start
                    self.skip_ws()
                    v = self.access()
            save = self.pos
            self.skip_ws()
            msg = self.opt(self.custom_message)
            if msg is None:
                self.pos = save
            return v, msg

        compare_with, msg = self.cut(
            rhs,
            'expecting either a property access "engine.core" or value like '
            '"string" or ["this", "that"]',
        )
        return mk(
            GuardAccessClause(
                access_clause=AccessClause(
                    query=query,
                    comparator=op,
                    comparator_inverse=inverse,
                    compare_with=compare_with,
                    custom_message=msg,
                    location=location,
                ),
                negation=negation,
            )
        )

    def block_clause(self) -> BlockGuardClause:
        """parser.rs:1047-1072: `query [!empty] { ... }`."""
        location = self.loc()
        query = self.access()
        save = self.pos
        not_empty = False
        try:
            self.skip_ws()
            self._not_kw()
            if not (self.try_tag("EMPTY") or self.try_tag("empty")):
                raise Backtrack(self.pos)
            not_empty = True
        except Backtrack:
            self.pos = save
        assignments, conjunctions = self._block(self.clause)
        return BlockGuardClause(
            query=query,
            block=Block(assignments=assignments, conjunctions=conjunctions),
            location=location,
            not_empty=not_empty,
        )

    def parameterized_rule_call_clause(self) -> ParameterizedNamedRuleClause:
        """parser.rs:1136-1160."""
        location = self.loc()
        negation = self.opt(self._not_kw) is not None
        name, params = self._call_expr()
        save = self.pos
        self.skip_ws()
        msg = self.opt(self.custom_message)
        if msg is None:
            self.pos = save
        return ParameterizedNamedRuleClause(
            parameters=params,
            named_rule=GuardNamedRuleClause(
                dependent_rule=name,
                negation=negation,
                custom_message=msg,
                location=location,
            ),
        )

    def clause(self):
        """parser.rs:1180-1198 (order: when-block, block, param-call, access)."""
        start = self.pos
        try:
            return self._when_block(self._single_clauses, self.clause, WhenBlockClause)
        except (Backtrack, Fatal) as e:
            if isinstance(e, Fatal):
                raise
            self.pos = start
        try:
            return self.block_clause()
        except Backtrack:
            self.pos = start
        try:
            return self.parameterized_rule_call_clause()
        except Backtrack:
            self.pos = start
        return self._access_clause(lambda c: c)

    def _single_clause(self):
        return self._access_clause(lambda c: c)

    def rule_clause(self) -> GuardNamedRuleClause:
        """Named-rule reference clause (parser.rs:1228-1278)."""
        self.skip_ws()
        location = self.loc()
        negation = self.opt(self._not_kw) is not None
        name = self.var_name()
        # peek: end, newline, comment, '{' or or-join (parser.rs:1242-1251)
        save = self.pos
        ok = False
        if self.pos >= self.n:
            ok = True
        else:
            self.skip_space0()
            c = self.peek()
            if c == "\n" or self.text.startswith("\r\n", self.pos) or c == "#" or c == "{":
                ok = True
            else:
                self.pos = save
                try:
                    self._or_join_peek()
                    ok = True
                except Backtrack:
                    pass
        self.pos = save
        if ok:
            return GuardNamedRuleClause(
                dependent_rule=name, negation=negation, custom_message=None, location=location
            )
        # else must be a custom message (parser.rs:1265-1277)
        self.skip_space0()
        msg = self.cut(self.custom_message, "expected custom message after rule name")
        return GuardNamedRuleClause(
            dependent_rule=name, negation=negation, custom_message=msg, location=location
        )

    def _or_join_peek(self):
        start = self.pos
        self.skip_ws()
        self._or_term()
        self.skip_ws1()
        self.pos = start

    def _or_term(self):
        for t in ("or", "OR", "|OR|"):
            if self.try_tag(t):
                return
        raise Backtrack(self.pos, "expected or")

    def _or_join(self):
        """parser.rs:1941-1947."""
        self.skip_ws()
        self._or_term()
        self.skip_ws1()

    # CNF machinery (parser.rs:1284-1347) ------------------------------
    def _disjunction(self, item_parser) -> List:
        items = [item_parser_first(self, item_parser)]
        while True:
            save = self.pos
            try:
                self._or_join()
                self.skip_ws()
                items.append(item_parser())
            except Backtrack:
                self.pos = save
                break
        return items

    def _cnf_clauses(self, item_parser) -> Conjunctions:
        conjunctions: Conjunctions = []
        while True:
            save = self.pos
            try:
                disj = self._disjunction(item_parser)
            except Backtrack:
                self.pos = save
                if not conjunctions:
                    raise Fatal(
                        self.pos,
                        f"There were no clauses present "
                        f"{self.file_name}#{self.loc().line}@{self.loc().column}",
                    )
                return conjunctions
            conjunctions.append(disj)

    def _single_clauses(self) -> Conjunctions:
        """single_clauses (parser.rs:1349-1384): when-condition clauses."""

        def item():
            start = self.pos
            try:
                return self._single_clause()
            except Backtrack:
                self.pos = start
            try:
                return self.parameterized_rule_call_clause()
            except Backtrack:
                self.pos = start
            return self.rule_clause()

        conjunctions: Conjunctions = []
        while True:
            save = self.pos
            try:
                disj = self._disjunction(item)
            except Backtrack:
                self.pos = save
                return conjunctions
            conjunctions.append(disj)

    # assignments (parser.rs:1414-1474) --------------------------------
    def assignment(self) -> LetExpr:
        self.tag("let")
        self.skip_ws1()
        var = self.var_name()
        self.cut(
            lambda: (
                self.skip_ws(),
                self.tag(":=") if self.text.startswith(":=", self.pos) else self.tag("="),
            ),
            "expected = or := after let variable",
        )
        start = self.pos
        try:
            value = self.parse_value()
            return LetExpr(var=var, value=value)
        except Backtrack:
            self.pos = start
        try:
            self.skip_ws()
            fn = self.function_expr()
            return LetExpr(var=var, value=fn)
        except (Backtrack, Fatal):
            self.pos = start
        self.skip_ws()
        acc = self.cut(self.access, "expected value, function call or query after =")
        return LetExpr(var=var, value=acc)

    # when-conditions + blocks (parser.rs:1479-1554) -------------------
    def _when_conditions(self, condition_parser) -> Conjunctions:
        self.skip_ws()
        if not (self.try_tag("when") or self.try_tag("WHEN")):
            raise Backtrack(self.pos, "expected when")
        self.cut(self.skip_ws1, "expected space after when")
        return condition_parser()

    def _block(self, clause_parser) -> Tuple[List[LetExpr], Conjunctions]:
        """block() (parser.rs:1510-1554)."""
        self.skip_ws()
        self.char("{")
        assignments: List[LetExpr] = []
        conjunctions: Conjunctions = []
        found = False
        while True:
            save = self.pos
            try:
                self.skip_ws()
                assignments.append(self.assignment())
                found = True
                continue
            except Backtrack:
                self.pos = save
            try:
                disj = self._disjunction(clause_parser)
                conjunctions.append(disj)
                found = True
                continue
            except Backtrack:
                self.pos = save
                break
        if not found:
            raise Backtrack(self.pos, "empty block")
        self.cut(lambda: (self.skip_ws(), self.char("}")), "expected } to close block")
        return assignments, conjunctions

    def _when_block(self, conditions_parser, block_parser, mapper):
        """when_block() (parser.rs:1661-1682)."""
        self.skip_ws()
        conds = self._when_conditions(conditions_parser)
        assignments, conjunctions = self._block(block_parser)
        return mapper(conds, Block(assignments=assignments, conjunctions=conjunctions))

    # type blocks (parser.rs:1556-1658) --------------------------------
    def type_name(self) -> str:
        start = self.pos
        try:
            a = self.var_name()
            self.tag("::")
            b = self.var_name()
            self.tag("::")
            c = self.var_name()
            self.try_tag("::MODULE")
            return f"{a}::{b}::{c}"
        except Backtrack:
            self.pos = start
        a = self.var_name()
        self.tag("::")
        b = self.var_name()
        return f"{a}::{b}"

    def type_block(self) -> TypeBlock:
        location = self.loc()
        name = self.type_name()
        self.cut(self.skip_ws1, "expected space after type name")
        conds = self.opt(lambda: self._when_conditions(self._single_clauses))
        if conds is not None:
            assignments, clauses = self.cut(
                lambda: self._block(self.clause), "expected block after type when conditions"
            )
        else:
            save = self.pos
            try:
                assignments, clauses = self._block(self.clause)
            except Backtrack:
                self.pos = save
                self.skip_ws()
                single = self.cut(self.clause, "expected clause after type name")
                assignments, clauses = [], [[single]]
        # synthesized query Resources.*[ Type == '<name>' ] (parser.rs:1631-1655)
        query = [
            QKey("Resources"),
            QAllValues(None),
            QFilter(
                None,
                [
                    [
                        GuardAccessClause(
                            access_clause=AccessClause(
                                query=AccessQuery(query=[QKey("Type")], match_all=True),
                                comparator=CmpOperator.Eq,
                                comparator_inverse=False,
                                compare_with=PV.string(Path.root(), name),
                                custom_message=None,
                                location=location,
                            ),
                            negation=False,
                        )
                    ]
                ],
            ),
        ]
        return TypeBlock(
            type_name=name,
            conditions=conds,
            block=Block(assignments=assignments, conjunctions=clauses),
            query=query,
        )

    # rule blocks (parser.rs:1684-1790) --------------------------------
    def _rule_block_clause(self):
        start = self.pos
        try:
            self.skip_ws()
            return self.type_block()
        except Backtrack:
            self.pos = start
        try:
            self.skip_ws()
            conds = self._when_conditions(self._single_clauses)
            assignments, conjunctions = self._block(self._clause_or_rule_clause)
            return WhenBlockClause(
                conditions=conds,
                block=Block(assignments=assignments, conjunctions=conjunctions),
            )
        except Backtrack:
            self.pos = start
        self.skip_ws()
        return self._clause_or_rule_clause()

    def _clause_or_rule_clause(self):
        start = self.pos
        try:
            return self.clause()
        except Backtrack:
            self.pos = start
        return self.rule_clause()

    def rule_block(self) -> Rule:
        self.skip_ws()
        self.tag("rule")
        self.skip_ws1()
        name = self.cut(self.var_name, "expected rule name")
        conds = self.opt(lambda: self._when_conditions(self._single_clauses))
        assignments, conjunctions = self.cut(
            lambda: self._block(self._rule_block_clause), "expected rule block"
        )
        return Rule(
            rule_name=name,
            conditions=conds,
            block=Block(assignments=assignments, conjunctions=conjunctions),
        )

    def parameterized_rule_block(self) -> ParameterizedRule:
        self.skip_ws()
        self.tag("rule")
        self.skip_ws1()
        name = self.cut(self.var_name, "expected rule name")
        self.char("(")
        params: List[str] = []
        while True:
            self.skip_ws()
            params.append(self.cut(self.var_name, "expected parameter name"))
            self.skip_ws()
            if not self.try_tag(","):
                break
        self.cut(lambda: self.char(")"), "expected ) after parameters")
        # dedupe preserving order (IndexSet)
        seen = set()
        unique = []
        for p in params:
            if p not in seen:
                seen.add(p)
                unique.append(p)
        assignments, conjunctions = self.cut(
            lambda: self._block(self._rule_block_clause), "expected rule block"
        )
        return ParameterizedRule(
            parameter_names=unique,
            rule=Rule(
                rule_name=name,
                conditions=None,
                block=Block(assignments=assignments, conjunctions=conjunctions),
            ),
        )


def item_parser_first(p: Parser, item_parser):
    p.skip_ws()
    return item_parser()


# ---------------------------------------------------------------------------
# top-level rules file (parser.rs:1840-1932)
# ---------------------------------------------------------------------------
def parse_rules_file(content: str, file_name: str = "") -> Optional[RulesFile]:
    p = Parser(content, file_name)
    p.skip_ws()
    if p.eof():
        return None

    assignments: List[LetExpr] = []
    named_rules: List[Rule] = []
    parameterized_rules: List[ParameterizedRule] = []
    default_rule_clauses: List[List] = []

    try:
        while True:
            p.skip_ws()
            if p.eof():
                break
            start = p.pos
            # order mirrors parser.rs:1852-1868
            try:
                assignments.append(p.assignment())
                continue
            except Backtrack:
                p.pos = start
            try:
                parameterized_rules.append(p.parameterized_rule_block())
                continue
            except Backtrack:
                p.pos = start
            try:
                named_rules.append(p.rule_block())
                continue
            except Backtrack:
                p.pos = start
            try:
                disj = p._disjunction(p.type_block)
                default_rule_clauses.append(list(disj))
                continue
            except Backtrack:
                p.pos = start
            try:
                wb = p._when_block(
                    p._single_clauses, p._clause_or_rule_clause, WhenBlockClause
                )
                default_rule_clauses.append([wb])
                continue
            except Backtrack:
                p.pos = start
            disj = p._disjunction(p.clause)
            default_rule_clauses.append(disj)
    except Backtrack as e:
        loc = p.loc(e.pos)
        raise ParseError(
            f"Error parsing file {file_name} at line {loc.line} at column "
            f"{loc.column}, when handling {e.context}, fragment "
            f"{content[e.pos:e.pos + 40]!r}"
        )
    except Fatal as e:
        loc = p.loc(e.pos)
        raise ParseError(
            f"Error parsing file {file_name} at line {loc.line} at column "
            f"{loc.column}, when handling {e.context}, fragment "
            f"{content[e.pos:e.pos + 40]!r}"
        )

    if default_rule_clauses:
        default_rule_name = (
            DEFAULT_RULE_NAME
            if not file_name.strip()
            else f"{file_name}/{DEFAULT_RULE_NAME}"
        )
        named_rules.insert(
            0,
            Rule(
                rule_name=default_rule_name,
                conditions=None,
                block=Block(assignments=[], conjunctions=default_rule_clauses),
            ),
        )

    return RulesFile(
        assignments=assignments,
        guard_rules=named_rules,
        parameterized_rules=parameterized_rules,
    )


def get_rule_name(rule_file_name: str, rule_name: str) -> str:
    """parser.rs:1828-1835."""
    prefix = f"{rule_file_name}/"
    return rule_name[len(prefix) :] if rule_name.startswith(prefix) else rule_name
