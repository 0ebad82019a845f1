"""Built-in functions for stateful rules.

The 15 functions callable from `let` assignments / clause RHS, with the
name -> arity registry the parser validates against. Mirrors
`guard/src/rules/eval_context.rs:1181-1268` (registry)
and `guard/src/rules/functions/` (semantics):
count (collections.rs:6), json_parse / regex_replace / substring /
to_upper / to_lower / join / url_decode (strings.rs), parse_* converters
(converters.rs), parse_epoch / now (date_time.rs).

Each function receives already-resolved argument lists of QueryResult and
returns a list of Optional[PV]; `None` entries are dropped by the caller
(`resolve_function`, eval_context.rs:2437-2472).
"""

from __future__ import annotations

import re
import datetime
import json
import time
import urllib.parse
from typing import List, Optional

import yaml

from .errors import IncompatibleError, ParseError
from .qresult import QueryResult, RESOLVED, LITERAL, UNRESOLVED
from .values import (
    BOOL,
    CHAR,
    FLOAT,
    INT,
    STRING,
    Path,
    PV,
    compiled_regex,
    from_plain,
)

# name -> expected number of args (eval_context.rs:1200-1218)
FUNCTION_ARITY = {
    "count": 1,
    "join": 2,
    "json_parse": 1,
    "now": 0,
    "parse_boolean": 1,
    "parse_char": 1,
    "parse_epoch": 1,
    "parse_float": 1,
    "parse_int": 1,
    "parse_string": 1,
    "regex_replace": 3,
    "substring": 3,
    "to_lower": 1,
    "to_upper": 1,
    "url_decode": 1,
}


def _resolved_pv(qr: QueryResult) -> Optional[PV]:
    if qr.tag != UNRESOLVED:
        return qr.value
    return None


def _first_resolved(args: List[QueryResult], err: str) -> PV:
    if not args:
        raise ParseError(err)
    v = _resolved_pv(args[0])
    if v is None:
        raise ParseError(err)
    return v


# ---------------------------------------------------------------------------
# collections
# ---------------------------------------------------------------------------
def fn_count(args: List[QueryResult]) -> List[Optional[PV]]:
    """collections.rs:6-23: number of resolved values in the query."""
    n = sum(1 for q in args if q.tag != UNRESOLVED)
    if not args:
        return [PV.int_(Path.root(), 0)]
    first = args[0]
    path = (
        first.value.self_path()
        if first.tag != UNRESOLVED
        else first.unresolved.traversed_to.self_path()
    )
    return [PV.int_(path, n)]


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------
def fn_json_parse(args: List[QueryResult]) -> List[Optional[PV]]:
    """strings.rs json_parse: YAML-parse each string value."""
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is not None and v.kind == STRING:
            try:
                data = yaml.safe_load(v.val)
            except yaml.YAMLError as e:
                raise ParseError(str(e))
            out.append(from_plain(data, v.self_path()))
        else:
            out.append(None)
    return out


def _rust_expand(template: str, match) -> str:
    """Expand $1 / ${name} capture references like fancy-regex's expand."""
    out = []
    i, n = 0, len(template)
    while i < n:
        c = template[i]
        if c == "$" and i + 1 < n:
            nxt = template[i + 1]
            if nxt == "$":
                out.append("$")
                i += 2
                continue
            if nxt == "{":
                end = template.find("}", i + 2)
                if end > 0:
                    name = template[i + 2 : end]
                    out.append(_group_of(match, name))
                    i = end + 1
                    continue
            j = i + 1
            while j < n and (template[j].isalnum() or template[j] == "_"):
                j += 1
            if j > i + 1:
                out.append(_group_of(match, template[i + 1 : j]))
                i = j
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _group_of(match, name: str) -> str:
    try:
        g = match.group(int(name)) if name.isdigit() else match.group(name)
    except (IndexError, KeyError):
        return ""
    return g or ""


def fn_regex_replace(args: List[List[QueryResult]]) -> List[Optional[PV]]:
    """strings.rs regex_replace: extract with capture groups, re-expand."""
    base, extract_q, replace_q = args
    extract = _first_resolved(
        extract_q, "regex_replace function requires the second argument to be a string"
    )
    replace = _first_resolved(
        replace_q, "regex_replace function requires the third argument to be a string"
    )
    if extract.kind != STRING or replace.kind != STRING:
        raise ParseError("regex_replace function requires string arguments")
    try:
        rx = compiled_regex(extract.val)
    except re.error as e:
        # the reference surfaces an invalid runtime pattern as a clean
        # evaluation error (strings.rs Regex::try_from(...)?), never a
        # crash — string arguments are not parse-time validated the
        # way regex literals are
        raise ParseError(
            f"regex_replace: invalid regular expression "
            f"{extract.val!r}: {e}"
        )
    out: List[Optional[PV]] = []
    for q in base:
        v = _resolved_pv(q)
        if v is not None and v.kind == STRING:
            pieces = [_rust_expand(replace.val, m) for m in rx.finditer(v.val)]
            out.append(PV.string(v.self_path(), "".join(pieces)))
        else:
            out.append(None)
    return out


def fn_substring(args: List[List[QueryResult]]) -> List[Optional[PV]]:
    """strings.rs substring: [from, to) slice; out-of-bounds -> skipped."""
    base, from_q, to_q = args

    def as_index(qlist, which):
        v = _first_resolved(
            qlist, f"substring function requires the {which} argument to be a number"
        )
        if v.kind not in (INT, FLOAT):
            raise ParseError(
                f"substring function requires the {which} argument to be a number"
            )
        return int(v.val)

    start = as_index(from_q, "second")
    end = as_index(to_q, "third")
    out: List[Optional[PV]] = []
    for q in base:
        v = _resolved_pv(q)
        if (
            v is not None
            and v.kind == STRING
            and v.val
            and start < end
            and start <= len(v.val)
            and end <= len(v.val)
        ):
            out.append(PV.string(v.self_path(), v.val[start:end]))
        else:
            out.append(None)
    return out


def _map_strings(args: List[QueryResult], f) -> List[Optional[PV]]:
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is not None and v.kind == STRING:
            out.append(PV.string(v.self_path(), f(v.val)))
        else:
            out.append(None)
    return out


def fn_to_upper(args: List[QueryResult]) -> List[Optional[PV]]:
    return _map_strings(args, str.upper)


def fn_to_lower(args: List[QueryResult]) -> List[Optional[PV]]:
    return _map_strings(args, str.lower)


def fn_url_decode(args: List[QueryResult]) -> List[Optional[PV]]:
    return _map_strings(args, urllib.parse.unquote)


def fn_join(args: List[List[QueryResult]]) -> List[Optional[PV]]:
    """strings.rs join: string values joined by a char/string delimiter."""
    collection, delim_q = args
    delim_pv = _first_resolved(
        delim_q, "join function requires the second argument to be either a char or string"
    )
    if delim_pv.kind not in (STRING, CHAR):
        raise ParseError(
            "join function requires the second argument to be either a char or string"
        )
    parts = []
    for q in collection:
        if q.tag == UNRESOLVED:
            raise IncompatibleError(
                f"Joining unresolved values is not allowed "
                f"{q.unresolved.traversed_to!r}, unsatisfied part {q.unresolved.remaining_query}"
            )
        v = q.value
        if v.kind != STRING:
            raise IncompatibleError(f"Joining non string values {v!r}")
        parts.append(v.val)
    path = (
        collection[0].value.self_path() if collection else Path.root()
    )
    return [PV.string(path, delim_pv.val.join(parts))]


# ---------------------------------------------------------------------------
# converters (converters.rs) — unsupported element types are skipped
# ---------------------------------------------------------------------------
def fn_parse_int(args: List[QueryResult]) -> List[Optional[PV]]:
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is None:
            out.append(None)
        elif v.kind == INT:
            out.append(v)
        elif v.kind == FLOAT:
            out.append(PV.int_(v.self_path(), int(v.val)))
        elif v.kind in (STRING, CHAR):
            try:
                out.append(PV.int_(v.self_path(), int(v.val.strip())))
            except ValueError:
                raise IncompatibleError(f"Cannot parse int from {v.val!r}")
        else:
            out.append(None)
    return out


def fn_parse_float(args: List[QueryResult]) -> List[Optional[PV]]:
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is None:
            out.append(None)
        elif v.kind == FLOAT:
            out.append(v)
        elif v.kind == INT:
            out.append(PV.float_(v.self_path(), float(v.val)))
        elif v.kind in (STRING, CHAR):
            try:
                out.append(PV.float_(v.self_path(), float(v.val.strip())))
            except ValueError:
                raise IncompatibleError(f"Cannot parse float from {v.val!r}")
        else:
            out.append(None)
    return out


def fn_parse_boolean(args: List[QueryResult]) -> List[Optional[PV]]:
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is None:
            out.append(None)
        elif v.kind == BOOL:
            out.append(v)
        elif v.kind == STRING:
            low = v.val.lower()
            if low == "true":
                out.append(PV.boolean(v.self_path(), True))
            elif low == "false":
                out.append(PV.boolean(v.self_path(), False))
            else:
                raise IncompatibleError(f"Cannot parse boolean from {v.val!r}")
        else:
            out.append(None)
    return out


def fn_parse_string(args: List[QueryResult]) -> List[Optional[PV]]:
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is None:
            out.append(None)
        elif v.kind == STRING:
            out.append(v)
        elif v.kind == BOOL:
            out.append(PV.string(v.self_path(), "true" if v.val else "false"))
        elif v.kind in (INT, CHAR):
            out.append(PV.string(v.self_path(), str(v.val)))
        elif v.kind == FLOAT:
            out.append(PV.string(v.self_path(), _format_float(v.val)))
        else:
            out.append(None)
    return out


def _format_float(f: float) -> str:
    """Rust Display for f64: integral floats print without '.0'? No —
    Rust prints 1.5 as '1.5' and 1.0 as '1'. Match Rust's fmt."""
    if f == int(f) and abs(f) < 1e16:
        return str(int(f))
    return repr(f)


def fn_parse_char(args: List[QueryResult]) -> List[Optional[PV]]:
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is None:
            out.append(None)
        elif v.kind == CHAR:
            out.append(v)
        elif v.kind == INT:
            if 0 <= v.val <= 9:
                out.append(PV.char(v.self_path(), str(v.val)))
            else:
                raise IncompatibleError(f"Cannot parse char from int {v.val}")
        elif v.kind == STRING:
            if len(v.val) == 1:
                out.append(PV.char(v.self_path(), v.val))
            else:
                raise IncompatibleError(f"Cannot parse char from string {v.val!r}")
        else:
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# date/time (date_time.rs)
# ---------------------------------------------------------------------------
def fn_parse_epoch(args: List[QueryResult]) -> List[Optional[PV]]:
    """RFC3339 timestamp string -> unix epoch seconds."""
    out: List[Optional[PV]] = []
    for q in args:
        v = _resolved_pv(q)
        if v is not None and v.kind == STRING:
            try:
                s = v.val.replace("Z", "+00:00")
                dt = datetime.datetime.fromisoformat(s)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=datetime.timezone.utc)
                out.append(PV.int_(v.self_path(), int(dt.timestamp())))
            except ValueError:
                raise IncompatibleError(f"Cannot parse epoch from {v.val!r}")
        else:
            out.append(None)
    return out


def fn_now(args: List[QueryResult]) -> List[Optional[PV]]:
    return [PV.int_(Path.root(), int(time.time()))]


# dispatch table; entries marked multi=True receive the full args list
_SINGLE_ARG = {
    "count": fn_count,
    "json_parse": fn_json_parse,
    "to_upper": fn_to_upper,
    "to_lower": fn_to_lower,
    "url_decode": fn_url_decode,
    "parse_int": fn_parse_int,
    "parse_float": fn_parse_float,
    "parse_boolean": fn_parse_boolean,
    "parse_string": fn_parse_string,
    "parse_char": fn_parse_char,
    "parse_epoch": fn_parse_epoch,
}

_MULTI_ARG = {
    "join": fn_join,
    "regex_replace": fn_regex_replace,
    "substring": fn_substring,
}


def call_function(name: str, args: List[List[QueryResult]]) -> List[Optional[PV]]:
    """FunctionName::call dispatch (eval_context.rs:1290-1310)."""
    if name == "now":
        return fn_now([])
    if name in _SINGLE_ARG:
        return _SINGLE_ARG[name](args[0])
    if name in _MULTI_ARG:
        return _MULTI_ARG[name](args)
    raise ParseError(f"No function with the name '{name}' exists.")
