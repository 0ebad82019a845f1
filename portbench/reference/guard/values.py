"""Path-aware value model: every node knows its JSON-pointer-ish path and
source location.

This is the working representation of both documents and DSL literal
values, equivalent to the reference's `PathAwareValue`
(`guard/src/rules/path_value.rs:172-185`) and `Value`
(`guard/src/rules/values.rs:82-95`), redesigned as a
single tagged node class (cheap dispatch, and trivially flattenable into
the columnar arrays the device backend consumes — see ops/encoder.py).

Comparison semantics mirror `path_value.rs:1047-1196`:
  * ordering is only defined between same-kind scalars (int/int,
    float/float, string/string, char/char, null/null) — int vs float is
    deliberately NOT coerced, matching `compare_values`
    (path_value.rs:1048-1070);
  * equality additionally understands string<->regex matching, ranges and
    deep list/map equality (`compare_eq`, path_value.rs:1071-1146).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from .errors import IncompatibleError, MultipleValuesError, NotComparableError

# ---------------------------------------------------------------------------
# Kinds (stable small ints: these double as the node-type column in the
# device columnar encoding, ops/encoder.py)
# ---------------------------------------------------------------------------
NULL = 0
STRING = 1
REGEX = 2
BOOL = 3
INT = 4
FLOAT = 5
CHAR = 6
LIST = 7
MAP = 8
RANGE_INT = 9
RANGE_FLOAT = 10
RANGE_CHAR = 11

_KIND_NAMES = {
    NULL: "null",
    STRING: "String",
    REGEX: "Regex",
    BOOL: "bool",
    INT: "int",
    FLOAT: "float",
    CHAR: "char",
    LIST: "array",
    MAP: "map",
    RANGE_INT: "range(int, int)",
    RANGE_FLOAT: "range(float, float)",
    RANGE_CHAR: "range(char, char)",
}

LOWER_INCLUSIVE = 0x01  # values.rs:239
UPPER_INCLUSIVE = 0x02  # values.rs:240


class Location:
    """Line/col of a node in its source file (path_value.rs:30-40)."""

    __slots__ = ("line", "col")

    def __init__(self, line: int = 0, col: int = 0):
        self.line = line
        self.col = col

    def __repr__(self):
        return f"L:{self.line},C:{self.col}"

    def __eq__(self, other):
        return (
            isinstance(other, Location)
            and self.line == other.line
            and self.col == other.col
        )

    def __hash__(self):
        return hash((self.line, self.col))


_ROOT_LOC = Location(0, 0)


class Path:
    """Slash-separated pointer from the document root (path_value.rs:48-49)."""

    __slots__ = ("s", "loc")

    def __init__(self, s: str = "", loc: Optional[Location] = None):
        self.s = s
        self.loc = loc if loc is not None else _ROOT_LOC

    @staticmethod
    def root() -> "Path":
        return Path("", _ROOT_LOC)

    def disp(self) -> str:
        """Path Display (path_value.rs:62-66): "{path}[L:{l},C:{c}]" —
        the form the reference embeds in unresolved reasons/messages."""
        return f"{self.s}[L:{self.loc.line},C:{self.loc.col}]"

    def extend(self, part: str, loc: Optional[Location] = None) -> "Path":
        return Path(self.s + "/" + part, loc if loc is not None else self.loc)

    def relative(self) -> str:
        """Last path component (path_value.rs:73-78)."""
        pos = self.s.rfind("/")
        return self.s[pos + 1 :] if pos >= 0 else self.s

    def __repr__(self):
        return f"Path({self.s!r})"

    def __eq__(self, other):
        return isinstance(other, Path) and self.s == other.s

    def __hash__(self):
        return hash(self.s)


class Range:
    """Numeric/char range literal, e.g. r[10, 20) (values.rs:232-240)."""

    __slots__ = ("lower", "upper", "inclusive")

    def __init__(self, lower, upper, inclusive: int):
        self.lower = lower
        self.upper = upper
        self.inclusive = inclusive

    def contains(self, v) -> bool:
        """values.rs:266-278 (is_within)."""
        lo_ok = (
            self.lower <= v if (self.inclusive & LOWER_INCLUSIVE) else self.lower < v
        )
        hi_ok = (
            self.upper >= v if (self.inclusive & UPPER_INCLUSIVE) else self.upper > v
        )
        return lo_ok and hi_ok

    def __repr__(self):
        o = "[" if self.inclusive & LOWER_INCLUSIVE else "("
        c = "]" if self.inclusive & UPPER_INCLUSIVE else ")"
        return f"r{o}{self.lower},{self.upper}{c}"

    def __eq__(self, other):
        return (
            isinstance(other, Range)
            and self.lower == other.lower
            and self.upper == other.upper
            and self.inclusive == other.inclusive
        )


class MapValue:
    """Ordered map that keeps the *key nodes* as well as the values so
    `keys ==` filters and key-capture projections can see key source
    locations (path_value.rs:139-142)."""

    __slots__ = ("keys", "values")

    def __init__(self, keys: Optional[List["PV"]] = None, values: Optional[Dict[str, "PV"]] = None):
        self.keys: List[PV] = keys if keys is not None else []
        self.values: Dict[str, PV] = values if values is not None else {}

    def is_empty(self) -> bool:
        return not self.values

    def __eq__(self, other):
        # MapValue PartialEq compares only values (path_value.rs:157-161)
        if not isinstance(other, MapValue):
            return NotImplemented
        if len(self.values) != len(other.values):
            return False
        for k, v in self.values.items():
            if k not in other.values or not loose_eq(v, other.values[k]):
                return False
        return True


class PV:
    """A path-aware value node (path_value.rs:172-185).

    `kind` is one of the module-level kind constants; `val` holds:
      NULL -> None; STRING/REGEX/CHAR -> str; BOOL -> bool; INT -> int;
      FLOAT -> float; LIST -> list[PV]; MAP -> MapValue;
      RANGE_* -> Range.
    """

    __slots__ = ("path", "kind", "val")

    def __init__(self, path: Path, kind: int, val):
        self.path = path
        self.kind = kind
        self.val = val

    # -- constructors -------------------------------------------------
    @staticmethod
    def null(path: Path) -> "PV":
        return PV(path, NULL, None)

    @staticmethod
    def string(path: Path, s: str) -> "PV":
        return PV(path, STRING, s)

    @staticmethod
    def regex(path: Path, s: str) -> "PV":
        return PV(path, REGEX, s)

    @staticmethod
    def boolean(path: Path, b: bool) -> "PV":
        return PV(path, BOOL, b)

    @staticmethod
    def int_(path: Path, i: int) -> "PV":
        return PV(path, INT, i)

    @staticmethod
    def float_(path: Path, f: float) -> "PV":
        return PV(path, FLOAT, f)

    @staticmethod
    def char(path: Path, c: str) -> "PV":
        return PV(path, CHAR, c)

    @staticmethod
    def list_(path: Path, items: List["PV"]) -> "PV":
        return PV(path, LIST, items)

    @staticmethod
    def map_(path: Path, mv: MapValue) -> "PV":
        return PV(path, MAP, mv)

    # -- shape predicates (path_value.rs:921-963) ---------------------
    def is_list(self) -> bool:
        return self.kind == LIST

    def is_map(self) -> bool:
        return self.kind == MAP

    def is_null(self) -> bool:
        return self.kind == NULL

    def is_scalar(self) -> bool:
        return self.kind != LIST and self.kind != MAP

    def type_info(self) -> str:
        return _KIND_NAMES[self.kind]

    def self_path(self) -> Path:
        return self.path

    # -- merge for --input-params docs (path_value.rs:889-919) --------
    def merge(self, other: "PV") -> "PV":
        if self.kind == LIST and other.kind == LIST:
            self.val.extend(other.val)
            return self
        if self.kind == MAP and other.kind == MAP:
            mv: MapValue = self.val
            omv: MapValue = other.val
            for key, value in omv.values.items():
                if key in mv.values:
                    raise MultipleValuesError(f"Key {key}, already exists in map")
                mv.values[key] = value
                mv.keys.append(PV.string(other.path.extend(key), key))
            return self
        raise IncompatibleError(
            f"Types are not compatible for merges {self.type_info()}, {other.type_info()}"
        )

    # -- python protocol ----------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, PV):
            return NotImplemented
        return loose_eq(self, other)

    def __hash__(self):
        # structural hash ignoring path (values.rs:97-153)
        k = self.kind
        if k in (STRING, REGEX, CHAR):
            return hash(self.val)
        if k == NULL:
            return hash("NULL")
        if k in (INT, BOOL):
            return hash(self.val)
        if k == FLOAT:
            return hash(int(self.val))
        if k == LIST:
            return hash(tuple(hash(e) for e in self.val))
        if k == MAP:
            return hash(tuple((kk, hash(vv)) for kk, vv in self.val.values.items()))
        r: Range = self.val
        return hash((r.lower, r.upper, r.inclusive))

    def __repr__(self):
        return f"PV({_KIND_NAMES[self.kind]}@{self.path.s!r}={self.val!r})"

    # -- plain-python projection (for reporters / JSON output) --------
    def to_plain(self):
        k = self.kind
        if k == NULL:
            return None
        if k == LIST:
            return [e.to_plain() for e in self.val]
        if k == MAP:
            return {kk: vv.to_plain() for kk, vv in self.val.values.items()}
        if k == REGEX:
            return f"/{self.val}/"
        if k in (RANGE_INT, RANGE_FLOAT, RANGE_CHAR):
            return repr(self.val)
        return self.val


# ---------------------------------------------------------------------------
# Regex compilation cache. The reference uses fancy-regex (lookaround +
# backreference support); Python `re` covers the same feature class.
# ---------------------------------------------------------------------------
_GLOBAL_FLAGS_RE = re.compile(r"\(\?([aiLmsux]+)\)")


@lru_cache(maxsize=4096)
def compiled_regex(pattern: str):
    try:
        try:
            return re.compile(pattern)
        except re.error:
            # Rust regex crates allow inline global flags anywhere in
            # the pattern (e.g. `^(?i)name$`); Python requires them at
            # the start. Hoist them to the front and retry.
            flags = "".join(
                sorted(set("".join(_GLOBAL_FLAGS_RE.findall(pattern))))
            )
            if not flags:
                raise
            stripped = _GLOBAL_FLAGS_RE.sub("", pattern)
            return re.compile(f"(?{flags})" + stripped)
    except OverflowError as e:
        # CPython raises OverflowError (not re.error) for repetition
        # counts beyond its limit (x{9999999999}); normalize so every
        # caller's re.error handling applies — the reference rejects
        # such patterns at parse time (parser.rs:273-277)
        raise re.error(f"invalid regex {pattern!r}: {e}")


def regex_matches(pattern: str, s: str) -> bool:
    """Unanchored match, like fancy_regex::Regex::is_match."""
    return compiled_regex(pattern).search(s) is not None


# ---------------------------------------------------------------------------
# Comparisons (path_value.rs:1047-1196)
# ---------------------------------------------------------------------------
_ORDERED_KINDS = {NULL, INT, STRING, FLOAT, CHAR}


def compare_values(first: PV, other: PV) -> int:
    """Total order only between same-kind scalars (path_value.rs:1048-1070)."""
    if first.kind == other.kind and first.kind in _ORDERED_KINDS:
        if first.kind == NULL:
            return 0
        a, b = first.val, other.val
        if a < b:
            return -1
        if a > b:
            return 1
        return 0
    raise NotComparableError(
        f"PathAwareValues are not comparable {first.type_info()}, {other.type_info()}"
    )


def compare_eq(first: PV, second: PV) -> bool:
    """Equality incl. regex matching / ranges (path_value.rs:1071-1146)."""
    fk, sk = first.kind, second.kind
    if fk == STRING and sk == REGEX:
        return regex_matches(second.val, first.val)
    if fk == REGEX and sk == STRING:
        return regex_matches(first.val, second.val)
    if fk == STRING and sk == STRING:
        return first.val == second.val
    if fk == MAP and sk == MAP:
        m1: MapValue = first.val
        m2: MapValue = second.val
        if len(m1.values) != len(m2.values):
            return False
        for key, value in m1.values.items():
            v2 = m2.values.get(key)
            if v2 is None or not compare_eq(value, v2):
                return False
        return True
    if fk == LIST and sk == LIST:
        if len(first.val) != len(second.val):
            return False
        return all(compare_eq(a, b) for a, b in zip(first.val, second.val))
    if fk == BOOL and sk == BOOL:
        return first.val == second.val
    if fk == REGEX and sk == REGEX:
        return first.val == second.val
    if fk == INT and sk == RANGE_INT:
        return second.val.contains(first.val)
    if fk == FLOAT and sk == RANGE_FLOAT:
        return second.val.contains(first.val)
    if fk == CHAR and sk == RANGE_CHAR:
        return second.val.contains(first.val)
    return compare_values(first, second) == 0


def loose_eq(first: PV, second: PV) -> bool:
    """PartialEq semantics: like compare_eq but never raises
    (path_value.rs:245-291); used by IN-containment checks."""
    fk, sk = first.kind, second.kind
    if fk == MAP and sk == MAP:
        return first.val == second.val  # MapValue.__eq__ (loose)
    if fk == LIST and sk == LIST:
        if len(first.val) != len(second.val):
            return False
        return all(loose_eq(a, b) for a, b in zip(first.val, second.val))
    if (fk == STRING and sk == REGEX) or (fk == REGEX and sk == STRING):
        pattern = second.val if sk == REGEX else first.val
        s = first.val if fk == STRING else second.val
        try:
            return regex_matches(pattern, s)
        except re.error:
            return False
    try:
        return compare_eq(first, second)
    except NotComparableError:
        return False


def _ord_cmp(op):
    def cmp(first: PV, other: PV) -> bool:
        return op(compare_values(first, other))

    return cmp


compare_lt = _ord_cmp(lambda o: o < 0)
compare_le = _ord_cmp(lambda o: o <= 0)
compare_gt = _ord_cmp(lambda o: o > 0)
compare_ge = _ord_cmp(lambda o: o >= 0)


# ---------------------------------------------------------------------------
# Conversion from plain python data (JSON payloads, test specs) — the
# equivalent of TryFrom<serde_json::Value> (path_value.rs:313-357).
# ---------------------------------------------------------------------------
def from_plain(value, path: Optional[Path] = None) -> PV:
    path = path if path is not None else Path.root()
    if value is None:
        return PV.null(path)
    if value is True or value is False:
        return PV.boolean(path, value)
    if isinstance(value, int):
        return PV.int_(path, value)
    if isinstance(value, float):
        return PV.float_(path, value)
    if isinstance(value, str):
        return PV.string(path, value)
    if isinstance(value, list):
        return PV.list_(
            path, [from_plain(v, path.extend(str(i))) for i, v in enumerate(value)]
        )
    if isinstance(value, dict):
        mv = MapValue()
        for k, v in value.items():
            ks = str(k)
            kp = path.extend(ks)
            mv.keys.append(PV.string(kp, ks))
            mv.values[ks] = from_plain(v, kp)
        return PV.map_(path, mv)
    raise IncompatibleError(f"Cannot convert {type(value)} to a path-aware value")


def _rust_num(v) -> str:
    """Rust {} Display for numbers: integral floats print bare."""
    import math

    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if float(v) == int(v) and abs(v) < 1e16:
        return str(int(v))
    return repr(float(v))


def plain_value_display(v) -> str:
    """ValueOnlyDisplay over a plain-python projection (reports store
    to_plain() values); same rendering rules as value_only_display."""
    if v is None:
        return '"NULL"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (int, float)):
        return _rust_num(v)
    if isinstance(v, list):
        return "[" + ",".join(plain_value_display(e) for e in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(
            f'"{k}":{plain_value_display(val)}' for k, val in v.items()
        ) + "}"
    return str(v)


def value_only_display(pv: "PV") -> str:
    """ValueOnlyDisplay (display.rs:42-99): the reference's value
    rendering used in clause-display contexts and console reporters —
    double-quoted strings, "/re/" regexes, "NULL", compact containers."""
    k = pv.kind
    if k == NULL:
        return '"NULL"'
    if k == STRING:
        return f'"{pv.val}"'
    if k == REGEX:
        return f'"/{pv.val}/"'
    if k == CHAR:
        return f"'{pv.val}'"
    if k == BOOL:
        return "true" if pv.val else "false"
    if k in (INT, FLOAT):
        return _rust_num(pv.val)
    if k == LIST:
        return "[" + ",".join(value_only_display(e) for e in pv.val) + "]"
    if k == MAP:
        return "{" + ",".join(
            f'"{kk}":{value_only_display(vv)}' for kk, vv in pv.val.values.items()
        ) + "}"
    r = pv.val  # ranges (display.rs write_range); char bounds print bare
    lo = "[" if r.inclusive & LOWER_INCLUSIVE else "("
    hi = "]" if r.inclusive & UPPER_INCLUSIVE else ")"

    def bound(b):
        return b if isinstance(b, str) else _rust_num(b)

    return f"{lo}{bound(r.lower)},{bound(r.upper)}{hi}"


def rust_debug_pv(pv: "PV") -> str:
    """Rust derive(Debug) rendering of a PathAwareValue, embedded in one
    unresolved reason (eval_context.rs:580-581 uses {:?} of the value)."""
    p = pv.path
    path = f'Path("{p.s}", Location {{ line: {p.loc.line}, col: {p.loc.col} }})'
    k = pv.kind
    if k == STRING:
        return f'String(({path}, "{pv.val}"))'
    if k == REGEX:
        return f'Regex(({path}, "{pv.val}"))'
    if k == CHAR:
        return f"Char(({path}, '{pv.val}'))"
    if k == BOOL:
        return f"Bool(({path}, {'true' if pv.val else 'false'}))"
    if k == INT:
        return f"Int(({path}, {pv.val}))"
    if k == FLOAT:
        fv = float(pv.val)
        if fv != fv or fv in (float("inf"), float("-inf")):
            # Rust {:?} renders non-finite f64 as NaN / inf / -inf
            s = "NaN" if fv != fv else ("inf" if fv > 0 else "-inf")
            return f"Float(({path}, {s}))"
        if fv == int(fv):
            return f"Float(({path}, {_rust_num(pv.val)}.0))"
        return f"Float(({path}, {pv.val}))"
    if k == NULL:
        return f"Null({path})"
    if k == LIST:
        inner = ", ".join(rust_debug_pv(e) for e in pv.val)
        return f"List(({path}, [{inner}]))"
    if k == MAP:
        entries = ", ".join(
            f'"{kk}": {rust_debug_pv(vv)}' for kk, vv in pv.val.values.items()
        )
        return f"Map(({path}, MapValue {{ values: {{{entries}}} }}))"
    return repr(pv)
