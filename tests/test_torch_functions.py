"""The port's function library against the JAX package's.

Every built-in of `_SINGLE_ARG` and `_MULTI_ARG` (core/functions.py)
runs on both packages over the same seeded arguments (numpy
`default_rng`): resolved strings, numbers, booleans, nulls, lists and
maps, plus UnResolved entries. The results must be equal as plain
values with their paths, in order, None where a value is skipped; where
the JAX function raises, the port must raise the same error class with
the same message. `now` is checked for its type and its `parse_epoch`
round trip only.
"""

import datetime

import numpy as np
import pytest

from guard_tpu.core import functions as jf
from guard_tpu.core import qresult as jq
from guard_tpu.core import values as jv
from guard_tpu_torch.core import functions as tf
from guard_tpu_torch.core import qresult as tq
from guard_tpu_torch.core import values as tv

SEEDS = range(6)

_WORDS = ["Prod-Logs", "dev", "QA-Box", "ALPHA_beta", "a b/c", "x%20y%2Fz",
          "caf%C3%A9", "", "42", " 7 ", "-13", "3.5", "1e3", "abc", "true",
          "FALSE", "yes", "5", "Z", '{"x": 1, "y": [2, 3]}', "[1, 2]",
          "k: v", "{bad", "2024-01-02T03:04:05Z", "1999-12-31T23:59:59+02:00",
          "2030-06-01T00:00:00", "not-a-date", "logs-prod-7"]


def to_plain(pv):
    """(kind, path, value) of a PV tree; the kind constants are the
    same numbers in both packages."""
    if pv is None:
        return None
    if pv.kind == jv.LIST:
        return (pv.kind, pv.path.s, [to_plain(x) for x in pv.val])
    if pv.kind == jv.MAP:
        return (pv.kind, pv.path.s,
                [(k.val, to_plain(pv.val.values[k.val])) for k in pv.val.keys])
    if pv.kind == jv.FLOAT:
        return (pv.kind, pv.path.s, repr(pv.val))
    return (pv.kind, pv.path.s, pv.val)


def _value(rng, scalar_only=False):
    r = rng.random()
    if r < 0.55:
        return _WORDS[int(rng.integers(len(_WORDS)))]
    if r < 0.68:
        return int(rng.integers(-20, 20))
    if r < 0.76:
        return float(rng.integers(-400, 400)) / 8
    if r < 0.82:
        return bool(rng.random() < 0.5)
    if r < 0.86 or scalar_only:
        return None
    if r < 0.93:
        return [_WORDS[int(rng.integers(len(_WORDS)))] for _ in range(2)]
    return {"k": _WORDS[int(rng.integers(len(_WORDS)))], "n": 1}


def _arg(rng, n, strings=False, unresolved=True):
    """A list of (plain value | "UNRESOLVED", path) query results."""
    out = []
    for i in range(n):
        if unresolved and rng.random() < 0.08:
            out.append(("UNRESOLVED", f"/Resources/r{i}"))
        elif strings:
            out.append((_WORDS[int(rng.integers(len(_WORDS)))], f"/Resources/r{i}/Name"))
        else:
            out.append((_value(rng), f"/Resources/r{i}/V"))
    return out


def _build(pkg_values, pkg_q, arg):
    res = []
    for value, path in arg:
        p = pkg_values.Path(path)
        if value == "UNRESOLVED":
            ur = pkg_q.UnResolved(pkg_values.PV.null(p), "Missing", "key missing")
            res.append(pkg_q.QueryResult.unresolved_(ur))
        elif isinstance(value, tuple) and value[0] == "CHAR":
            res.append(pkg_q.QueryResult.literal(pkg_values.PV.char(p, value[1])))
        else:
            res.append(pkg_q.QueryResult.resolved(pkg_values.from_plain(value, p)))
    return res


# values each function mostly accepts, so that the seeded cases reach
# both its results and its errors
_POOLS = {
    "parse_char": ["Z", "5", 3, 0, "q"],
    "parse_epoch": ["2024-01-02T03:04:05Z", "1999-12-31T23:59:59+02:00",
                    "2030-06-01T00:00:00", "1970-01-01T00:00:00Z", 7],
    "json_parse": ['{"x": 1, "y": [2, 3]}', "[1, 2]", "k: v", "7", "plain"],
    "parse_boolean": ["true", "FALSE", True, "False", 3],
    "parse_int": ["42", " 7 ", 3.9, -2, True],
    "parse_float": ["3.5", "1e3", 2, "-0.25", None],
}


def _pooled(rng, name, n):
    pool = _POOLS[name]
    out = []
    for i in range(n):
        if rng.random() < 0.06:
            v = _WORDS[int(rng.integers(len(_WORDS)))]  # may be refused
        else:
            v = pool[int(rng.integers(len(pool)))]
        out.append((v, f"/Resources/r{i}/V"))
    return out


def _args_for(name, seed):
    rng = np.random.default_rng(seed * 31 + len(name))
    n = int(rng.integers(1, 6))
    if name in _POOLS and seed % 2 == 0:
        return [_pooled(rng, name, n)]
    if name in ("to_upper", "to_lower", "url_decode", "parse_epoch", "json_parse"):
        # strings mostly, with the odd non-string that is skipped
        return [_arg(rng, n, strings=rng.random() < 0.7)]
    if name == "join":
        delim = [(",", "/d")], [(("CHAR", "-"), "/d")], [(3, "/d")], []
        return [_arg(rng, n, strings=rng.random() < 0.8),
                delim[int(rng.integers(len(delim)))]]
    if name == "regex_replace":
        pats = [r"^(\w+)-(\w+)$", r"(?P<head>[a-z]+)", "[0-9]", "(", ""]
        reps = ["${2}_${1}", "$1/$2", "<$head>", "$$", "x", "${9}"]
        pat = pats[int(rng.integers(len(pats)))]
        rep = reps[int(rng.integers(len(reps)))]
        extract = [(pat, "/p")] if rng.random() < 0.9 else [(5, "/p")]
        return [_arg(rng, n, strings=True), extract, [(rep, "/r")]]
    if name == "substring":
        def idx():
            v = [0, 1, 2, 4, 9, 2.7, "3", None][int(rng.integers(8))]
            return [] if v is None else [(v, "/i")]
        return [_arg(rng, n, strings=rng.random() < 0.8), idx(), idx()]
    return [_arg(rng, n)]


NAMES = sorted(set(jf._SINGLE_ARG) | set(jf._MULTI_ARG))


def test_tables_are_copies():
    assert sorted(tf._SINGLE_ARG) == sorted(jf._SINGLE_ARG)
    assert sorted(tf._MULTI_ARG) == sorted(jf._MULTI_ARG)
    assert tf.FUNCTION_ARITY == jf.FUNCTION_ARITY


def _call(pkg_f, pkg_values, pkg_q, name, args):
    built = [_build(pkg_values, pkg_q, a) for a in args]
    try:
        return "ok", [to_plain(v) for v in pkg_f.call_function(name, built)]
    except Exception as e:  # the error itself is what is compared
        return "raise", (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_function_matches_jax(name, seed):
    args = _args_for(name, seed)
    want = _call(jf, jv, jq, name, args)
    got = _call(tf, tv, tq, name, args)
    assert got == want


def test_raising_cases_raise_alike():
    """The error paths the seeded cases may miss, one each."""
    cases = [
        ("parse_int", [[("abc", "/a")]]),
        ("parse_float", [[("1.2.3", "/a")]]),
        ("parse_boolean", [[("maybe", "/a")]]),
        ("parse_char", [[("ab", "/a")]]),
        ("parse_char", [[(12, "/a")]]),
        ("parse_epoch", [[("yesterday", "/a")]]),
        ("json_parse", [[("{bad", "/a")]]),
        ("join", [[("UNRESOLVED", "/a")], [(",", "/d")]]),
        ("join", [[(1, "/a")], [(",", "/d")]]),
        ("join", [[("a", "/a")], [(3, "/d")]]),
        ("regex_replace", [[("a", "/a")], [("(", "/p")], [("x", "/r")]]),
        ("substring", [[("abc", "/a")], [("x", "/i")], [(2, "/i")]]),
        ("no_such_function", [[("a", "/a")]]),
    ]
    for name, args in cases:
        want = _call(jf, jv, jq, name, args)
        assert want[0] == "raise", name
        assert _call(tf, tv, tq, name, args) == want


def test_now_is_an_int_that_round_trips_through_parse_epoch():
    (t_now,) = tf.call_function("now", [])
    assert t_now.kind == tv.INT and t_now.path.s == ""
    stamp = datetime.datetime.fromtimestamp(t_now.val, datetime.timezone.utc)
    arg = [tq.QueryResult.resolved(tv.PV.string(tv.Path("/t"), stamp.isoformat()))]
    (back,) = tf.call_function("parse_epoch", [arg])
    assert back.val == t_now.val
    (j_now,) = jf.call_function("now", [])
    assert abs(j_now.val - t_now.val) <= 5
