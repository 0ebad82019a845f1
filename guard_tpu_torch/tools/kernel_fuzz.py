"""Kernel-vs-oracle differential fuzzer of the port, on the card.

    python -m guard_tpu_torch.tools.kernel_fuzz [--time 420] [--seed S]
        [--device cuda|cpu] [--no-corpus] [--crash-dir DIR]

Random rule files from a tagged grammar over random documents, lowered
by the port (core/parser, ops/fnvars, ops/encoder, ops/ir) and run
through parallel/device.DeviceBatchEvaluator with its K3 rim, then
through `with_summary` for K7's per-rule counts. Each trial holds:

  (a) on a card, the card against the CPU (the plain versions of the
      kernels) on the same compiled program: statuses, raw unsure bits,
      the six rim blocks and the K7 counts equal, no tolerance;
  (b) every (document, rule) status that is not unsure against the CPU
      oracle (core/evaluator.eval_rules_file and
      commands/report.rule_statuses_from_root); where the oracle raises,
      the document's row carries an unsure bit;
  (c) where the native oracle is built (ops/native_oracle), its
      statuses and simplified report against the CPU oracle's, on the
      trials of generated rules over small documents;
  (d) on a card, the trial's documents repeated to at least TILE_ROWS
      rows, past K3's block form (1,024 rows): each row's statuses,
      unsure bits and rim rows equal its untiled row's, and the K7
      counts the untiled counts times the repeats.

Every 17th trial of a `big_docs` run is one bucket-crossing document
(`rand_big_doc`: K2's split grid, the one-row forms of K4-K6), and every
fifth trial of `main` a corpus rules file over random documents. With
`--time 420` this is the nightly tier; tests/test_torch_kernel_fuzz.py
holds the CI tier on the CPU. The generator is the one of the JAX
package's tools/kernel_fuzz.py, symbol for symbol: one
`random.Random(seed)` draws the same rules text, tags and documents in
both.

The entry point runs on the card unless `--device cpu` is passed; with
no card and no `--device` it exits 2. A divergence writes its rules
text, documents and message to `--crash-dir` and exits 1, as does a run
of more than 200 trials that leaves a grammar tag unseen.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent

STATUS = {0: "PASS", 1: "FAIL", 2: "SKIP"}

KEYS = ["Type", "Name", "Size", "Enc", "Tags", "Props", "Env", "Arn", "Vals"]
TYPES = ["Bucket", "Volume", "Task", "Other"]
STRS = ["prod", "dev", "a", "arn:aws:s3", "PROD-1", ""]
NUMS = [0, 1, 7, 443, 16777217, -3]

# every construct the generator can emit; the harness asserts coverage
ALL_TAGS = frozenset(
    {
        "binary", "unary", "filter", "deep-key", "query-rhs", "filter-unary",
        "keys-filter", "keys-membership", "index", "this-block", "list-walk",
        "var-set", "var-strings", "count", "fn-upper", "fn-parse-int",
        "when-gate", "or-join", "some", "interp", "interp-index",
        "membership-var", "struct-eq", "struct-neq", "struct-regex-member",
        "struct-range-member", "struct-in-list", "list-in-list",
        "neq-var-scope", "when-fn-let", "nested-inline-call",
        "per-origin-call", "per-origin-when-guard",
        "per-origin-filter-call", "cross-scope-var",
    }
)


def rand_value(rng, depth=0):
    r = rng.random()
    if depth < 2 and r < 0.25:
        return {
            rng.choice(KEYS): rand_value(rng, depth + 1)
            for _ in range(rng.randint(1, 3))
        }
    if depth < 2 and r < 0.4:
        return [rand_value(rng, depth + 1) for _ in range(rng.randint(0, 3))]
    r = rng.random()
    if r < 0.35:
        return rng.choice(STRS)
    if r < 0.6:
        return rng.choice(NUMS)
    if r < 0.7:
        return rng.random() * 100
    if r < 0.8:
        return rng.choice([True, False])
    if r < 0.9:
        return None
    return rng.choice(STRS)


def rand_doc(rng):
    resources = {}
    # occasionally WIDE documents (cross the 64/128 node-bucket
    # boundaries, so mixed-size batches split across bucket groups)
    n_res = rng.randint(1, 4) if rng.random() < 0.85 else rng.randint(8, 24)
    for i in range(n_res):
        res = {"Type": rng.choice(TYPES)}
        for _ in range(rng.randint(1, 4)):
            res[rng.choice(KEYS)] = rand_value(rng)
        resources[f"r{i}"] = res
    # occasionally a DEEP chain (long parent paths stress the chain
    # anchor columns and UnResolved accounting at depth)
    if rng.random() < 0.15:
        node = {}
        resources["deep"] = {"Type": rng.choice(TYPES), "Props": node}
        for k in range(rng.randint(5, 12)):
            nxt = {} if rng.random() < 0.8 else [rand_value(rng)]
            node[rng.choice(KEYS)] = nxt
            if isinstance(nxt, dict):
                node = nxt
            else:
                break
    doc = {"Resources": resources}
    if rng.random() < 0.4:
        doc["Settings"] = {"Allowed": rng.sample(STRS, 2), "Cap": rng.choice(NUMS)}
    return doc


def _lit(rng, tags):
    r = rng.random()
    if r < 0.25:
        return f"'{rng.choice(STRS)}'"
    if r < 0.45:
        return str(rng.choice(NUMS))
    if r < 0.55:
        return rng.choice(["true", "false", "null", "1.5"])
    if r < 0.65:
        return rng.choice(["/prod/", "/^arn:/", "/\\d+/"])
    if r < 0.72:
        return rng.choice(["r(0,100)", "r[1,443]"])
    if r < 0.86:
        return rng.choice(["['prod', 'dev']", "[0, 1, 443]", "[]"])
    # struct literals, incl. regex / range members (round 3)
    r2 = rng.random()
    if r2 < 0.4:
        tags.add("struct-eq")
        return rng.choice(
            ['{ "Env": "prod" }', '{ "Enc": true, "Size": 7 }']
        )
    if r2 < 0.65:
        tags.add("struct-regex-member")
        return '{ "Name": /prod/ }'
    if r2 < 0.85:
        tags.add("struct-range-member")
        return '{ "Size": r(0, 500) }'
    tags.add("struct-in-list")
    return '[{ "Key": "prod" }, { "Key": /dev/ }]'


def _op(rng):
    return rng.choice(["==", "!=", ">", ">=", "<", "<=", "in", "not in"])


def _unary(rng):
    return rng.choice(
        ["exists", "!exists", "empty", "!empty", "is_string", "is_list", "is_int"]
    )


def _clause(rng, i, tags):
    key = rng.choice(KEYS)
    key2 = rng.choice(KEYS)
    some = rng.choice(["", "some "])
    if some:
        tags.add("some")

    def lit():
        return _lit(rng, tags)

    def t(tag, s):
        tags.add(tag)
        return s

    shapes = [
        lambda: t("binary", f"{some}Resources.*.{key} {_op(rng)} {lit()}"),
        lambda: t("unary", f"{some}Resources.*.{key} {_unary(rng)}"),
        lambda: t(
            "filter",
            f"{some}Resources.*[ Type == '{rng.choice(TYPES)}' ].{key} {_op(rng)} {lit()}",
        ),
        lambda: t("deep-key", f"{some}Resources.*.{key}.{key2} {_op(rng)} {lit()}"),
        lambda: t(
            "query-rhs", f"{some}Resources.*.{key} {_op(rng)} Resources.*.{key2}"
        ),
        lambda: t(
            "list-in-list",
            f"{some}Resources.*.{key} {rng.choice(['in', 'not in'])} Resources.*.{key2}",
        ),
        lambda: t(
            "filter-unary",
            f"{some}Resources.*[ {key} {_unary(rng)} ].{key2}[*] {_op(rng)} {lit()}",
        ),
        lambda: t("keys-filter", f"Resources[ keys == /r\\d/ ].{key} {_unary(rng)}"),
        lambda: t(
            "keys-membership",
            f"Resources[ keys {rng.choice(['in', 'not in', '!='])} "
            f"{rng.choice(['/r1/', chr(39) + 'r0' + chr(39)])} ].{key} {_unary(rng)}",
        ),
        lambda: t("index", f"{some}Resources.*.{key}[0] {_op(rng)} {lit()}"),
        lambda: t(
            "this-block", f"Resources.*.{key} {{ this {_op(rng)} {lit()} }}"
        ),
        lambda: t(
            "list-walk", f"{some}Resources.*.Tags[*].{key} {_op(rng)} {lit()}"
        ),
        lambda: t(
            "struct-neq",
            f"Resources.*.{key} != "
            + rng.choice(['{ "Env": "prod" }', '{ "Name": /prod/ }']),
        ),
    ]
    return rng.choice(shapes)()


def rand_rules(rng, ti, tags):
    parts = []
    nv = rng.randint(0, 2)
    var_names = []
    for v in range(nv):
        kind = rng.random()
        key = rng.choice(KEYS)
        if kind < 0.4:
            tags.add("var-set")
            parts.append(
                f"let v{v} = Resources.*[ Type == '{rng.choice(TYPES)}' ]"
            )
        elif kind < 0.6:
            tags.add("var-strings")
            parts.append(f"let v{v} = some Resources.*.{key}")
        elif kind < 0.75:
            tags.add("count")
            parts.append(f"let v{v} = count(Resources.*.{key})")
        elif kind < 0.9:
            tags.add("fn-upper")
            parts.append(f"let v{v} = to_upper(Resources.*.Name)")
        else:
            tags.add("fn-parse-int")
            parts.append(f"let v{v} = parse_int(Resources.*.Size)")
        var_names.append((f"v{v}", kind))
    for ri in range(rng.randint(2, 4)):
        gate = ""
        when_body_let = ""
        if rng.random() < 0.5:
            tags.add("when-gate")
            if var_names and rng.random() < 0.5:
                vn, kind = rng.choice(var_names)
                if kind < 0.6:
                    gate = f" when %{vn} !empty"
                elif kind < 0.75:
                    gate = f" when %{vn} {rng.choice(['==', '>', '<='])} {rng.choice(NUMS)}"
                else:
                    gate = f" when %{vn} !empty"
            else:
                gate = " when Resources exists"
        body = []
        if rng.random() < 0.2:
            # function let inside a when block (round 3): the let and
            # its use live in a nested `when` that keeps the root basis
            tags.add("when-fn-let")
            body.append(
                "when Resources exists {\n"
                "        let wupper = to_upper(Resources.*.Name)\n"
                f"        {rng.choice(['some ', ''])}%wupper {_op(rng)} /PROD/\n"
                "    }"
            )
        if rng.random() < 0.15 and var_names:
            # inline call in a nested clause with root-bound var args
            vn, kind = rng.choice(var_names)
            if kind < 0.6:
                tags.add("nested-inline-call")
                body.append(
                    "Resources.* {\n"
                    f"        {rng.choice(KEYS)} exists or\n"
                    f"        Name == to_lower(%{vn}.Name)\n"
                    "    }"
                )
        if rng.random() < 0.2:
            # per-origin inline call (round 5 'pexpr'): the query
            # argument re-roots at each block candidate, so the RHS
            # differs per origin; random value kinds exercise the
            # fn-error -> oracle routing too
            tags.add("per-origin-call")
            fn, arg = rng.choice(
                [
                    ("to_lower", "Name"), ("to_upper", "Name"),
                    ("to_upper", "Env"), ("parse_int", "Size"),
                ]
            )
            por_op = rng.choice(["==", "!=", "<", ">=", "in"])
            inner = f"{rng.choice(KEYS)} {por_op} {fn}({arg})"
            if rng.random() < 0.4:
                # defensive-guard idiom: the when gate must exclude
                # guard-false origins from the precompute
                tags.add("per-origin-when-guard")
                inner = (
                    f"when {arg} exists {{\n"
                    f"            {inner}\n"
                    "        }"
                )
            body.append(
                "Resources.* {\n"
                f"        {inner}\n"
                "    }"
            )
        if rng.random() < 0.15:
            # per-origin call INSIDE a query filter (round 5b):
            # candidates replay from the query prefix
            tags.add("per-origin-filter-call")
            fn, arg = rng.choice(
                [("to_lower", "Name"), ("to_upper", "Env")]
            )
            body.append(
                f"Resources.*[ {arg} {rng.choice(['==', '!='])} "
                f"{fn}({arg}) ] {rng.choice(['exists', '!empty', 'empty'])}"
            )
        if rng.random() < 0.15:
            # cross-scope value-scope variable as clause RHS
            # (round 5b 'pvar'): bound per resource, used one scope
            # deeper (filter or nested block)
            tags.add("cross-scope-var")
            bind_key = rng.choice(["Type", "Name", "Size"])
            use_key = rng.choice(KEYS)
            op = rng.choice(["==", "!=", "in", "<", ">="])
            if rng.random() < 0.5:
                body.append(
                    "Resources.* {\n"
                    f"        let xv = {bind_key}\n"
                    f"        Props[ {use_key} {op} %xv ] "
                    f"{rng.choice(['exists', '!empty'])}\n"
                    "    }"
                )
            else:
                body.append(
                    "Resources.* {\n"
                    f"        let xv = {bind_key}\n"
                    "        Tags[*] {\n"
                    f"            {use_key} {op} %xv\n"
                    "        }\n"
                    "    }"
                )
        for ci in range(rng.randint(1, 3)):
            if var_names and rng.random() < 0.4:
                vn, kind = rng.choice(var_names)
                if kind < 0.4:  # resource-set var
                    tags.add("var-set")
                    body.append(
                        rng.choice(
                            [
                                f"%{vn}.{rng.choice(KEYS)} {_op(rng)} {_lit(rng, tags)}",
                                f"%{vn}[ {rng.choice(KEYS)} exists ].{rng.choice(KEYS)} {_unary(rng)}",
                                f"%{vn} {_unary(rng)}",
                            ]
                        )
                    )
                elif kind < 0.6:  # string-set var
                    tags.add("var-strings")
                    choice = rng.random()
                    if choice < 0.2:
                        body.append(f"%{vn} {_op(rng)} {rng.choice(NUMS)}")
                    elif choice < 0.4:
                        tags.add("interp")
                        body.append(f"Resources.%{vn} {_unary(rng)}")
                    elif choice < 0.55:
                        tags.add("interp-index")
                        body.append(f"Resources.%{vn}[0] {_unary(rng)}")
                    elif choice < 0.75:
                        tags.add("membership-var")
                        body.append(
                            f"Resources.*.{rng.choice(KEYS)} IN %{vn}"
                        )
                    else:
                        # negated Eq against a root-bound RHS inside a
                        # value scope (round 3)
                        tags.add("neq-var-scope")
                        body.append(
                            f"Resources.*[ {rng.choice(KEYS)} != %{vn} ] "
                            f"{rng.choice(['empty', '!empty'])}"
                        )
                elif kind < 0.75:
                    tags.add("count")
                    body.append(f"%{vn} {_op(rng)} {rng.choice(NUMS)}")
                else:
                    body.append(
                        f"{rng.choice(['some ', ''])}%{vn} {_op(rng)} {_lit(rng, tags)}"
                    )
            else:
                body.append(_clause(rng, ci, tags))
        if rng.random() < 0.25:
            tags.add("or-join")
            joiner = " or\n    "
        else:
            joiner = "\n    "
        parts.append(
            f"rule t{ti}_r{ri}{gate} {{\n    " + joiner.join(body) + "\n}"
        )
    return "\n\n".join(parts)


def rand_big_doc(rng):
    """Bucket-crossing document: a wide+deep tree targeting the 16k+
    node buckets (the O(N) gather formulation's home turf)."""
    wide = {}
    # ~20 encoded nodes per item: the common draw crosses the 8192
    # bucket into 16384, and one in four reaches the 32768 bucket (the
    # 65536 top bucket stays out — pairwise rule files there are too
    # slow for a time-budgeted CPU soak)
    if rng.random() < 0.25:
        n_items = rng.randint(900, 1600)
    else:
        n_items = rng.randint(450, 850)
    for i in range(n_items):
        entry = {
            "Type": rng.choice(TYPES),
            "Name": f"r{i}",
            "Size": rng.choice(NUMS),
            "Tags": [
                {"K": rng.choice(STRS), "V": rng.choice(STRS)}
                for _ in range(rng.randint(0, 6))
            ],
        }
        # occasional deep chain
        if rng.random() < 0.1:
            node = entry
            for d in range(rng.randint(10, 60)):
                node["Next"] = {"Depth": d}
                node = node["Next"]
        wide[f"res{i}"] = entry
    return {"Resources": wide}


# -- the port's side: evaluate, compare, report ------------------------

#: rows the tiled leg repeats a trial's documents to: past K3's block
#: form, which takes at most 1,024 rows (kRimBlockMaxD,
#: csrc/guard_kernels.cu)
TILE_ROWS = 1100

#: what the legs ran, summed over the process: trials held card against
#: CPU (a), tiled (d), documents held against the native oracle (c),
#: big-document and corpus trials
STATS = {"card_vs_cpu": 0, "tiled": 0, "native_docs": 0, "big": 0, "corpus": 0}

_TABLE_FORMS = {32: "warp", 256: "block", 0: "global"}
#: each kernel with forms: its launcher's own choice for a launch shape
#: (the *_branch functions of csrc/guard_kernels.cu and guard_joins.cu)
#: and the names of its codes
FORMS = {
    "segment_sum_rows": (
        lambda lib, s: lib.guard_segment_sum_branch(*s),
        {8: "group8", 16: "group16", 32: "group32", 256: "block", 0: "split"},
    ),
    "rim_reduce": (
        lambda lib, s: lib.guard_rim_reduce_branch(*s),
        {1: "thread", 32: "warp", 256: "block"},
    ),
    "set_count_rows": (lambda lib, s: lib.guard_set_count_branch(s[0], s[2]), _TABLE_FORMS),
    "distinct_first_rows": (lambda lib, s: lib.guard_distinct_first_branch(*s), _TABLE_FORMS),
    "seg_min_max_rows": (
        lambda lib, s: lib.guard_seg_min_max_branch(*s), {256: "block", 0: "grid"},
    ),
    "rule_summary": (
        lambda lib, s: lib.guard_rule_summary_branch(*s),
        {1: "block", 2: "cluster", 8: "grid8", 16: "grid16"},
    ),
}


def kernel_forms(shapes) -> Dict[str, Dict[str, int]]:
    """Launches of each kernel with forms, by the form its launcher takes
    at each launch shape of `shapes` (a kernels.SHAPES-like mapping of
    name to Counter of shapes). Empty counts where nothing launched, as
    on the CPU."""
    from .. import kernels as K

    out = {}
    for name, (branch, names) in FORMS.items():
        counts: Dict[str, int] = {}
        for shape, n in shapes.get(name, {}).items():
            code = int(branch(K._lib(), shape))
            form = names.get(code, f"form{code}")
            counts[form] = counts.get(form, 0) + n
        out[name] = dict(sorted(counts.items()))
    return out


@dataclass
class Divergence:
    """One disagreement, with the inputs that reproduce it."""

    message: str
    rules_text: str
    docs: list
    doc: Optional[int] = None  # the document it concerns, when one

    def __str__(self) -> str:
        text = f"{self.message}\nRULES:\n{self.rules_text}"
        if self.doc is not None:
            text += f"\nDOC: {self.docs[self.doc]}"
        return text


def write_reproducer(crash_dir, n: int, div: Divergence) -> Path:
    """`crash_dir`/divergence-NNN/: rules.guard, documents.json (the
    trial's documents in order) and divergence.txt."""
    d = Path(crash_dir) / f"divergence-{n:03d}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "rules.guard").write_text(div.rules_text)
    (d / "documents.json").write_text(json.dumps(div.docs, indent=1))
    (d / "divergence.txt").write_text(str(div) + "\n")
    return d


_native_cache: dict = {}


def _native_for(rules_text, rf):
    from ..ops.native_oracle import NativeOracle, NativeUnsupported, native_available

    if not native_available():
        return None
    native = _native_cache.get(rules_text)
    if native is False:
        return None  # cached negative: this rule file doesn't compile
    if native is None:
        if len(_native_cache) > 64:
            for o in _native_cache.values():
                if o is not False:
                    o.close()
            _native_cache.clear()
        try:
            native = NativeOracle(rf)
        except NativeUnsupported:
            _native_cache[rules_text] = False
            return None
        _native_cache[rules_text] = native
    return native


def native_leg(rules_text, rf, doc, py_root, py_statuses, label) -> List[str]:
    """Leg (c): ONE native eval_report call yields both the merged
    statuses and the simplified report; both must match the CPU
    oracle's single evaluation (py_root). Returns divergence messages."""
    from ..commands.report import simplified_report_from_root
    from ..ops.native_oracle import NativeEvalError, NativeUnsupported

    native = _native_for(rules_text, rf)
    if native is None:
        return []
    try:
        rep, statuses, _overall = native.eval_report(doc, "fuzz.json")
    except NativeUnsupported:
        return []  # declined: the documented fall-back contract
    except NativeEvalError as e:
        # the CPU oracle SUCCEEDED on this doc (caller checked), so a
        # native evaluation error is itself a divergence
        return [f"{label}: native errors ({e}) where python succeeds"]
    STATS["native_docs"] += 1
    out = []
    nat = {n: s.value for n, s in statuses.items()}
    if nat != py_statuses:
        out.append(f"{label}: NATIVE={nat} python={py_statuses}")
    if rep != simplified_report_from_root(py_root, "fuzz.json"):
        out.append(f"{label}: native report != python report")
    return out


def oracle_statuses(rf, doc, with_root=False):
    """The CPU oracle's {rule name: status} of one document (and its
    event root), or None where the evaluation raises."""
    from ..commands.report import rule_statuses_from_root
    from ..core.errors import GuardError
    from ..core.evaluator import eval_rules_file
    from ..core.scopes import RootScope

    scope = RootScope(rf, doc)
    try:
        eval_rules_file(rf, scope, "fuzz.json" if with_root else None)
    except GuardError:
        return (None, None) if with_root else None
    root = scope.reset_recorder().extract()
    statuses = {n: s.value for n, s in rule_statuses_from_root(root).items()}
    return (statuses, root) if with_root else statuses


@dataclass
class Run:
    """What one evaluation of a batch returned to the host."""

    statuses: np.ndarray  # (D, R) int8
    unsure: Optional[np.ndarray]  # (D, R) bool; None where the program emits none
    rim: tuple  # K3's six blocks
    counts: np.ndarray  # (3, R) int32, K7 behind with_summary
    summary_statuses: np.ndarray  # (D, R) int8 of the with_summary walk


def make_evaluator(compiled, device, fn=None):
    """DeviceBatchEvaluator over `compiled` on `device`, with the rim of
    the one file (K3 behind each walk)."""
    from ..ops.ir import build_rim_spec
    from ..parallel.device import DeviceBatchEvaluator

    return DeviceBatchEvaluator(compiled, device, rim_spec=build_rim_spec([compiled.rules]),
                                fn=fn)


def run_program(evaluator, batch) -> Run:
    """The walk and K3 (dispatch, collect), then the walk and K7
    (with_summary), of one batch."""
    st, un, rim = evaluator.collect(evaluator.dispatch(batch))
    summary_statuses, counts = evaluator.with_summary(batch)
    return Run(st, un, tuple(rim), counts, summary_statuses)


def _np_counts(statuses: np.ndarray) -> np.ndarray:
    return np.stack([(statuses == k).sum(axis=0) for k in range(3)]).astype(np.int32)


def self_check(run: Run) -> List[str]:
    """What one run must hold on its own: with_summary's walk gives the
    dispatch's statuses, and K7's counts are numpy's counts of them."""
    out = []
    if not np.array_equal(run.summary_statuses, run.statuses):
        out.append("with_summary's statuses != the dispatch's")
    if not np.array_equal(run.counts, _np_counts(run.statuses)):
        out.append(f"K7 counts {run.counts.tolist()} != numpy's "
                   f"{_np_counts(run.statuses).tolist()}")
    return out


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def diff_runs(a: Run, b: Run) -> List[str]:
    """The fields in which two runs differ, bit for bit."""
    out = [f for f in ("statuses", "unsure", "counts")
           if not _same(getattr(a, f), getattr(b, f))]
    out += [f"rim block {k}" for k in range(6) if not _same(a.rim[k], b.rim[k])]
    return out


def tiled_leg(evaluator, batch, base: Run) -> List[str]:
    """Leg (d): the batch's documents repeated to at least TILE_ROWS
    rows; each row must give its untiled row's statuses, unsure bits
    and rim rows, and K7 the untiled counts times the repeats."""
    from ..ops.encoder import take_doc_subset

    n = batch.n_docs
    reps = math.ceil(TILE_ROWS / n)
    rows = np.tile(np.arange(n), reps)
    run = run_program(evaluator, take_doc_subset(batch, rows))
    want = Run(base.statuses[rows], None if base.unsure is None else base.unsure[rows],
               tuple(b[rows] for b in base.rim), base.counts * reps, base.statuses[rows])
    STATS["tiled"] += 1
    return [f"tiled to {n * reps} rows: {p}" for p in self_check(run)] + [
        f"tiled to {n * reps} rows: {f} != the untiled rows'" for f in diff_runs(run, want)
    ]


def check_case(rf, rules_text: str, docs_plain: list, device, label: str,
               native: bool = True, tile: bool = True):
    """Evaluate one (rules, documents) case on `device` and hold it by
    the legs (a)-(d). Returns (cells checked against the oracle,
    [Divergence])."""
    import torch

    from ..core.values import from_plain
    from ..ops.encoder import encode_batch
    from ..ops.fnvars import precompute_fn_values
    from ..ops.ir import compile_rules_file
    from ..parallel.device import build_walk

    docs = [from_plain(d) for d in docs_plain]
    fn_vars, fn_vals, fn_err = precompute_fn_values(rf, docs)
    batch, interner = encode_batch(docs, fn_values=fn_vals, fn_var_order=fn_vars)
    compiled = compile_rules_file(rf, interner)
    if not compiled.rules:
        return 0, []
    divergences: List[Divergence] = []

    def diverge(message, doc=None):
        divergences.append(Divergence(message, rules_text, docs_plain, doc))

    fn = build_walk(compiled)
    evaluator = make_evaluator(compiled, device, fn)
    run = run_program(evaluator, batch)
    for problem in self_check(run):
        diverge(f"{label}: {problem}")
    if evaluator.device.type == "cuda":
        # leg (a): the same program on the CPU, the kernels' plain versions
        cpu_run = run_program(make_evaluator(compiled, torch.device("cpu"), fn), batch)
        STATS["card_vs_cpu"] += 1
        for field in diff_runs(run, cpu_run):
            diverge(f"{label}: card != cpu in {field}")
        if tile:
            for problem in tiled_leg(evaluator, batch, run):
                diverge(f"{label}: {problem}")
    statuses, unsure = run.statuses, run.unsure
    checked = 0
    for di in range(len(docs)):
        if di in fn_err:
            continue  # routed to the oracle (error path) by design
        oracle, py_root = oracle_statuses(rf, docs[di], with_root=True)
        if oracle is None:
            if not (unsure is not None and bool(unsure[di].any())):
                diverge(f"{label} doc={di}: oracle raises but no unsure flag", di)
            continue
        if native:
            for d in native_leg(rules_text, rf, docs[di], py_root, oracle,
                                f"{label} doc={di}"):
                diverge(d, di)
        for ri, crule in enumerate(compiled.rules):
            if unsure is not None and bool(unsure[di, ri]):
                continue
            dev = STATUS[int(statuses[di, ri])]
            if dev != oracle[crule.name]:
                diverge(f"{label} doc={di} rule={crule.name}: device={dev} "
                        f"oracle={oracle[crule.name]}", di)
            else:
                checked += 1
    return checked, divergences


def run_trial(rng, ti, tags, device="cpu", big_docs=False) -> tuple:
    """One differential trial of generated rules. Returns (checked,
    [Divergence])."""
    from ..core.errors import GuardError
    from ..core.parser import parse_rules_file

    rules_text = rand_rules(rng, ti, tags)
    try:
        rf = parse_rules_file(rules_text, "fuzz.guard")
    except GuardError:
        return 0, []
    big = big_docs and ti % 17 == 16
    if big:
        # bucket-crossing leg: ONE big document takes K2's split grid
        # and the one-row forms of K4-K6 (not tiled: it is one row)
        STATS["big"] += 1
        docs_plain = [rand_big_doc(rng)]
    else:
        docs_plain = [rand_doc(rng) for _ in range(6)]
    # the native report of a big document, and the CPU oracle's it is
    # held against, take a minute of host time: leg (c) skips it
    return check_case(rf, rules_text, docs_plain, device, f"trial={ti}", native=not big,
                      tile=not big)


def run_corpus_trial(rng, rule_path, device="cpu") -> tuple:
    """A differential trial seeded with a CORPUS rules file over random
    documents (interactions the generator grammar misses)."""
    from ..core.parser import parse_rules_file

    rule_path = Path(rule_path)
    text = rule_path.read_text()
    rf = parse_rules_file(text, rule_path.name)
    docs_plain = [rand_doc(rng) for _ in range(4)]
    STATS["corpus"] += 1
    return check_case(rf, text, docs_plain, device, f"corpus={rule_path.name}", native=False)


def fuzz(seconds: float, seed: int, device, corpus: bool = True, crash_dir=None) -> dict:
    """Trials until `seconds` pass, stopping at the first divergence: generated trials with big documents on, every
    fifth a corpus trial unless `corpus` is off. Writes a reproducer a
    divergence under `crash_dir` (when given). Returns the run's summary:
    trials, checked cells, tags, divergences (the first five as text),
    and on a card the launches of each kernel and their forms."""
    from collections import Counter

    from .. import kernels as K

    rng = random.Random(seed)
    files = sorted((REPO / "corpus" / "rules").glob("*.guard")) if corpus else []
    launches0 = dict(K.LAUNCHES)
    shapes0 = {name: Counter(K.SHAPES[name]) for name in K.NAMES}
    stats0 = dict(STATS)
    tags: set = set()
    t0 = time.monotonic()
    deadline = t0 + seconds
    checked = trials = 0
    found: List[Divergence] = []
    while time.monotonic() < deadline:
        if files and trials % 5 == 4:
            c, div = run_corpus_trial(rng, rng.choice(files), device)
        else:
            c, div = run_trial(rng, trials, tags, device, big_docs=True)
        checked += c
        found.extend(div)
        trials += 1
        if found:
            break
    seconds_run = time.monotonic() - t0
    reproducers = []
    if crash_dir is not None:
        reproducers = [str(write_reproducer(crash_dir, i, d)) for i, d in enumerate(found)]
    shapes = {name: Counter(K.SHAPES[name]) - shapes0[name] for name in K.NAMES}
    return {
        "seed": seed, "device": str(device), "seconds": seconds_run, "trials": trials,
        "checked": checked, "tags": len(tags), "tags_total": len(ALL_TAGS),
        "missing": sorted(ALL_TAGS - tags),
        "legs": {k: STATS[k] - stats0[k] for k in STATS},
        "launches": {name: K.LAUNCHES[name] - launches0[name] for name in K.NAMES},
        "forms": kernel_forms(shapes),
        "divergences": len(found), "first_divergences": [str(d) for d in found[:5]],
        "reproducers": reproducers,
    }


@contextmanager
def _native_oracle_in(tmp: Path):
    """The port's native oracle for leg (c) while the context lasts:
    the library already built, else built now into `tmp` (never into
    native/), the library directory restored on exit. Where g++ cannot
    build it, leg (c) is off and says so."""
    from ..ops import _native_lib, native_oracle

    if native_oracle.native_available():
        yield
        return
    saved = _native_lib.NATIVE_DIR, dict(_native_lib._libs), native_oracle._configured
    _native_lib.NATIVE_DIR = tmp
    native_oracle._configured = None
    try:
        try:
            native_oracle.build_native()
        except RuntimeError as e:
            print(f"kernel_fuzz: native oracle not built, leg (c) off ({e})", file=sys.stderr)
        yield
    finally:
        _native_cache.clear()
        _native_lib.NATIVE_DIR, libs, native_oracle._configured = saved
        _native_lib._libs.clear()
        _native_lib._libs.update(libs)


def main(argv=None) -> int:
    import tempfile

    import torch

    ap = argparse.ArgumentParser(
        prog="python -m guard_tpu_torch.tools.kernel_fuzz", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--time", type=float, default=420.0, help="time budget in seconds")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--no-corpus", action="store_true", help="skip corpus-seeded trials")
    ap.add_argument("--device", default="cuda",
                    help="the device of the evaluation (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--crash-dir", default=str(REPO / "kernel_fuzz_crashes"),
                    help="where a divergence writes its reproducer")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("kernel_fuzz: no CUDA device is available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    seed = args.seed if args.seed is not None else int(time.time())
    print(f"kernel differential fuzz: budget {args.time}s seed {seed} device {device}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="kernel_fuzz_") as tmp, _native_oracle_in(Path(tmp)):
        summary = fuzz(args.time, seed, device, corpus=not args.no_corpus,
                       crash_dir=args.crash_dir)
    print(
        f"trials={summary['trials']} checked={summary['checked']} "
        f"tags={summary['tags']}/{summary['tags_total']} missing={summary['missing']}"
    )
    print(f"legs={json.dumps(summary['legs'])}")
    if device.type == "cuda":
        print(f"launches={json.dumps(summary['launches'])}")
        print(f"forms={json.dumps(summary['forms'])}")
    if summary["divergences"]:
        print("DIVERGENCES:")
        for d in summary["first_divergences"]:
            print(d)
        print(f"reproducers: {summary['reproducers']}")
        return 1
    if summary["trials"] > 200 and summary["missing"]:
        # long runs must exercise the whole tagged grammar
        print(f"generator never produced: {summary['missing']}")
        return 1
    print("no divergences")
    return 0


if __name__ == "__main__":
    sys.exit(main())
