"""Query-RHS compares and `.%var` key interpolation: the port against JAX.

Rules whose clauses compare a query with a query (Eq, In and the
orderings, against a shared root-bound RHS and a per-origin RHS, plain,
under `not` and under `some`, in blocks and at rule level) or
interpolate `.%var` and `.%var[k]` keys, over seeded documents. The
port's statuses and rim blocks (`ops.backend.evaluate` on the CPU, with
the plain kernel versions) must equal the JAX package's `BatchEvaluator`
on every document that neither flags unsure; raw unsure bits, statuses
and rim blocks must equal a gather-forced JAX run in a subprocess
(GUARD_TPU_GATHER_CPU_MIN_NODES=0): below 32 nodes the JAX package's
one-hot arm decides list-in-subset-list pairs exactly where the gather
arm, which the port follows, flags them unsure.

Also here: the seven corpus files of this construct family over their
corpus test inputs, `workloads.XREF_RULES` over seeded templates, seeded
`tools/kernel_fuzz.py` trials of the query-RHS shapes, and the operator
matrix of tests/test_operator_matrix.py held against the CPU oracle.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu.ops.encoder import encode_batch as j_encode
from guard_tpu.ops.ir import compile_rules_file as j_compile
from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.ops.encoder import encode_batch as t_encode
from guard_tpu_torch.core.values import from_plain as t_from_plain
from guard_tpu_torch.ops.ir import StepKeyInterpVar
from guard_tpu_torch.ops.ir import compile_rules_file as t_compile
from guard_tpu_torch.workloads import XREF_RULES, make_xref_template
from test_operator_matrix import BINARY_OPS, LHS_DOCS, STATUS, _oracle
from test_torch_carry import corpus_case
from test_torch_walk import _GATHER_SCRIPT, ROOT, jax_eval, port_eval

sys.path.insert(0, os.path.join(ROOT, "tools"))
import kernel_fuzz  # noqa: E402

QUERY_RHS_CORPUS = [
    "query_vs_query_053.guard", "var_query_rhs_047.guard",
    "var_query_rhs_v1_111.guard", "var_query_rhs_v2_172.guard",
    "var_query_rhs_v3_234.guard", "var_interpolation_048.guard",
    "var_interpolation_v2_173.guard",
]

# a root-bound RHS variable used in a value scope: one shared RHS set
SHARED_RULES = """
let pool = Settings.Allowed
let cap = Settings.Cap
rule eq_shared { Resources.* { Name == %pool } }
rule neq_shared { Resources.* { Name != %pool } }
rule some_eq_shared { Resources.* { some Tags[*] == %pool } }
rule in_shared { Resources.* { Name IN %pool } }
rule not_in_shared { Resources.* { Name not in %pool } }
rule some_in_shared { Resources.* { some Tags[*] in %pool } }
rule lt_shared { Resources.* { Size < %cap } }
rule ge_shared { Resources.* { Size >= %cap } }
rule not_le_shared { Resources.* { not Size <= %cap } }
rule some_gt_shared { Resources.* { some Tags[*] > %cap } }
rule list_in_shared { Resources.* { Tags in %pool } }
"""

# the RHS walks from each origin: one RHS set per origin
PER_ORIGIN_RULES = """
rule eq_origin { Resources.* { Name == Alias } }
rule neq_origin { Resources.* { Name != Alias } }
rule some_eq_origin { Resources.* { some Tags[*] == Alias } }
rule in_origin { Resources.* { Name in Tags } }
rule not_in_origin { Resources.* { Name not in Tags } }
rule some_in_origin { Resources.* { some Tags[*] in Alias } }
rule le_origin { Resources.* { Size <= Cap } }
rule gt_origin { Resources.* { Size > Cap } }
rule not_lt_origin { Resources.* { not Size < Cap } }
rule some_ge_origin { Resources.* { some Tags[*] >= Cap } }
rule list_in_origin { Resources.* { Tags in Alias } }
"""

# rule-level clauses evaluate from the root and read origin 1
RULE_ROOT_RULES = """
let pool = Settings.Allowed
rule eq_root { Resources.*.Name == Settings.Allowed }
rule neq_root { Resources.*.Name != Settings.Allowed }
rule some_eq_root { some Resources.*.Name == Settings.Allowed }
rule in_root { Resources.*.Name in Settings.Allowed }
rule not_in_root { Resources.*.Name not in %pool }
rule lt_root { Resources.*.Size < Settings.Cap }
rule some_ge_root { some Resources.*.Size >= Settings.Cap }
rule eq_var_root when %pool !empty { Resources.*.Alias == %pool }
"""

INTERP_RULES = """
let names = Selection.targets
rule interp { Resources.%names.Type == 'Bucket' }
rule interp_exists { Resources.%names exists }
rule interp_first { Resources.%names[0].Type == 'Bucket' }
rule interp_third { Resources.%names[2] exists }
rule interp_block { Resources.%names { Type exists } }
rule interp_scope { Resources.* { Props.%names !empty } }
"""

VALUES = ["a", "b", "prod", "", 0, 1, 2, 7, -3, 1.5, 2.5, None, True,
          [1, 2], ["a", "b"], [], {"k": 1}, [["a"], ["b"]]]
SCALARS = ["a", "b", "prod", 1, 2, 7, -3, 1.5, None]


def _pick(rng, items):
    return items[int(rng.integers(len(items)))]


def query_doc(rng, n_res=None) -> dict:
    """A template of 1-4 resources whose Name/Alias/Size/Cap/Tags/Props
    take every value kind, with Settings (the shared RHS) and Selection
    (the interpolated key list: resource names, missing names, a bare
    string, nested lists, occasionally a number)."""
    n_res = int(rng.integers(1, 5)) if n_res is None else n_res
    names = [f"r{j}" for j in range(n_res)]
    res = {}
    for name in names:
        r = {"Type": _pick(rng, ["Bucket", "Volume"])}
        for key in ("Name", "Alias", "Size", "Cap"):
            if rng.random() < 0.85:
                r[key] = _pick(rng, VALUES if rng.random() < 0.4 else SCALARS)
        if rng.random() < 0.7:
            r["Tags"] = [_pick(rng, SCALARS) for _ in range(int(rng.integers(0, 4)))]
        if rng.random() < 0.5:
            r["Props"] = {_pick(rng, names + ["x"]): _pick(rng, SCALARS)
                          for _ in range(int(rng.integers(0, 3)))}
        res[name] = r
    doc = {"Resources": res}
    if rng.random() < 0.85:
        doc["Settings"] = {
            "Allowed": [_pick(rng, SCALARS) for _ in range(int(rng.integers(0, 4)))]
            if rng.random() < 0.8 else _pick(rng, VALUES),
            "Cap": _pick(rng, VALUES if rng.random() < 0.3 else SCALARS),
        }
    if rng.random() < 0.85:
        r = rng.random()
        if r < 0.55:
            targets = [_pick(rng, names + ["ghost", "x"]) for _ in range(int(rng.integers(0, 4)))]
        elif r < 0.7:
            targets = _pick(rng, names)
        elif r < 0.85:
            targets = [[_pick(rng, names)], _pick(rng, names)]
        else:
            targets = [_pick(rng, names), 3]  # a number: the oracle decides
        doc["Selection"] = {"targets": targets}
    return doc


def docs_for(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    # a few wide documents cross into the next node bucket
    return [query_doc(rng, 12 if i % 8 == 7 else None) for i in range(n)]


def _query_clause(rng, i):
    """A kernel_fuzz clause of the query-RHS shapes."""
    while True:
        tags = set()
        text = kernel_fuzz._clause(rng, i, tags)
        if tags & {"query-rhs", "list-in-list"}:
            return text


def fuzz_case(seed: int):
    """Rules of kernel_fuzz query-RHS clauses (plus a membership and an
    interpolation clause against string-set variables) over kernel_fuzz
    documents."""
    rng = random.Random(seed)
    parts = ["let names = some Resources.*.Name", "let allowed = Settings.Allowed"]
    for ri in range(3):
        body = [_query_clause(rng, ci) for ci in range(rng.randint(1, 2))]
        body.append(rng.choice([
            f"Resources.*.{rng.choice(kernel_fuzz.KEYS)} IN %allowed",
            f"Resources.*[ Name != %allowed ] {rng.choice(['empty', '!empty'])}",
            f"Resources.%names {rng.choice(['exists', '!exists'])}",
            "Resources.%names[0] exists",
        ]))
        gate = " when Resources exists" if rng.random() < 0.3 else ""
        parts.append(f"rule f{seed}_{ri}{gate} {{\n    " + "\n    ".join(body) + "\n}")
    docs = [kernel_fuzz.rand_doc(rng) for _ in range(8)]
    return "\n\n".join(parts), docs


def cases():
    yield "shared", SHARED_RULES, docs_for(1)
    yield "per_origin", PER_ORIGIN_RULES, docs_for(2)
    yield "rule_root", RULE_ROOT_RULES, docs_for(3)
    yield "interp", INTERP_RULES, docs_for(4)
    rng = np.random.default_rng(5)
    yield "xref", XREF_RULES, [make_xref_template(rng, i) for i in range(32)]
    for name in QUERY_RHS_CORPUS:
        text, docs = corpus_case(name)
        yield name, text, docs
    for seed in range(6):
        text, docs = fuzz_case(seed)
        yield f"fuzz{seed}", text, docs


CASES = list(cases())
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,text,docs", CASES, ids=IDS)
def test_statuses_and_rim_match_batch_evaluator(name, text, docs):
    fr = port_eval(text, docs)
    statuses, rim = jax_eval(text, docs)
    cells = ~fr.unsure
    assert cells.mean() >= 0.5, "too few results the device decides"
    np.testing.assert_array_equal(fr.statuses[cells], np.asarray(statuses)[cells])
    sure = cells.all(axis=1)
    assert sure.any()
    for k in (0, 2, 3, 5):
        assert fr.rim[k].dtype == np.asarray(rim[k]).dtype, k
        np.testing.assert_array_equal(fr.rim[k][sure], np.asarray(rim[k])[sure])


@pytest.fixture(scope="module")
def gather_reference():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "GUARD_TPU_GATHER_ON_CPU": "1",
        "GUARD_TPU_GATHER_CPU_MIN_NODES": "0",
        "PYTHONPATH": ROOT,
    })
    proc = subprocess.run(
        [sys.executable, "-c", _GATHER_SCRIPT],
        input=json.dumps([[t, d] for _n, t, d in CASES]),
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


@pytest.mark.parametrize("k", range(len(CASES)), ids=IDS)
def test_unsure_bits_match_gather_forced_reference(gather_reference, k):
    _name, text, docs = CASES[k]
    ref = gather_reference[k]
    fr = port_eval(text, docs)
    np.testing.assert_array_equal(fr.statuses, np.array(ref["statuses"], np.int8))
    assert ref["unsure"] is not None and fr.compiled.needs_unsure
    np.testing.assert_array_equal(fr.unsure, np.array(ref["unsure"], bool))
    for mine, theirs in zip(fr.rim, ref["rim"]):
        np.testing.assert_array_equal(mine, np.array(theirs, mine.dtype))


def test_cases_reach_every_arm():
    """The walk cases above take every query-RHS arm and both unsure
    flags (subset-mode list IN list, a non-string interpolated key)."""
    seen = set()
    for _name, text, docs in CASES[:5]:
        batch, interner = t_encode([t_from_plain(d) for d in docs])
        compiled = t_compile(t_parse(text, "r.guard"), interner)

        def visit(conj):
            for disj in conj:
                for n in disj:
                    if getattr(n, "rhs_query_steps", None) is not None:
                        seen.add((n.op.name, n.rhs_query_from_root, n.op_not, n.match_all))
                    for s in getattr(n, "steps", None) or []:
                        if isinstance(s, StepKeyInterpVar):
                            seen.add(("interp", s.index))
                    if hasattr(n, "inner"):
                        visit(n.inner)

        for rule in compiled.rules:
            visit(rule.conjunctions)
    for op in ("Eq", "In", "Lt", "Le", "Gt", "Ge"):
        for shared in (True, False):
            assert any(s[0] == op and s[1] == shared for s in seen), (op, shared)
    for op in ("Eq", "In"):
        for shared in (True, False):
            assert (op, shared, True, True) in seen, (op, "not", shared)
            assert (op, shared, False, False) in seen, (op, "some", shared)
    assert {("interp", None), ("interp", 0), ("interp", 2)} <= seen
    unsure = {n: port_eval(t, d).unsure.any() for n, t, d in CASES[:4]}
    assert unsure["shared"] and unsure["per_origin"] and unsure["interp"]


def test_xref_rules_lower_as_documented():
    rng = np.random.default_rng(0)
    docs = [make_xref_template(rng, i) for i in range(8)]
    _batch, interner = t_encode([t_from_plain(d) for d in docs])
    compiled = t_compile(t_parse(XREF_RULES, "xref.guard"), interner)
    assert compiled.fn_vars == [] and not compiled.host_rules
    got = {}

    def visit(rule, conj):
        for disj in conj:
            for n in disj:
                if getattr(n, "rhs_query_steps", None) is not None:
                    got.setdefault(rule, []).append((n.op.name, n.rhs_query_from_root, n.op_not))
                for s in getattr(n, "steps", None) or []:
                    if isinstance(s, StepKeyInterpVar):
                        got.setdefault(rule, []).append(("interp", s.index))
                if hasattr(n, "inner"):
                    visit(rule, n.inner)

    for rule in compiled.rules:
        visit(rule.name, rule.conjunctions)
    assert got == {
        "sse_allowed": [("In", True, False)],
        "volume_size_cap": [("Le", True, False)],
        "asg_capacity_ordered": [("Le", False, False), ("Ge", False, False)],
        "audited_are_buckets": [("interp", None)],
        "reviewed_matches_audited": [("Eq", False, True)],
    }
    # every rule decides on the device, and each status occurs
    fr = port_eval(XREF_RULES, [make_xref_template(rng, i) for i in range(64)])
    assert not fr.unsure.any()
    for r in range(len(compiled.rules)):
        assert {0, 1} <= set(fr.statuses[:, r].tolist()), compiled.rules[r].name


def test_query_rhs_matrix():
    """tests/test_operator_matrix.py::test_query_rhs_matrix on the port:
    every binary op against a query RHS of every shape, final statuses
    against the CPU oracle on the documents the device decides."""
    rules = [f"rule q{j} when Props exists {{ Props.v {op} Props.r }}"
             for j, op in enumerate(BINARY_OPS)]
    docs, names = [], []
    for lhs_name, lhs_doc in LHS_DOCS.items():
        for r in ("a", 1, 1.5, True, None, [0, 1], {"k": 1}):
            d = {"Props": dict(lhs_doc["Props"])}
            d["Props"]["r"] = r
            docs.append(d)
            names.append(f"{lhs_name}-vs-{r!r}")
    text = "\n".join(rules)
    fr = port_eval(text, docs)
    rf = j_parse(text, "qmatrix.guard")
    mismatches = []
    decided = 0
    for di, name in enumerate(names):
        oracle = _oracle(rf, j_from_plain(docs[di]))
        for ri, crule in enumerate(fr.compiled.rules):
            if fr.unsure[di, ri]:
                continue
            decided += 1
            dev = STATUS[int(fr.statuses[di, ri])]
            if dev != oracle[crule.name]:
                mismatches.append(f"{name} {crule.name}: port={dev} oracle={oracle[crule.name]}")
    assert not mismatches, "\n".join(mismatches[:25])
    assert decided > len(docs) * len(rules) // 2


def test_in_process_jax_and_port_lower_alike():
    # the same programs on both sides: struct ids and string ranks ship
    shipped = set()
    for _name, text, docs in CASES[:5]:
        jb, ji = j_encode([j_from_plain(d) for d in docs])
        tb, ti = t_encode([t_from_plain(d) for d in docs])
        ja = j_compile(j_parse(text, "r.guard"), ji).device_arrays(jb)
        ta = t_compile(t_parse(text, "r.guard"), ti).device_arrays(tb)
        assert list(ja) == list(ta)
        shipped.update(ta)
        for k in ja:
            assert ja[k].dtype == ta[k].dtype and ja[k].tobytes() == ta[k].tobytes(), k
    assert {"struct_id", "str_rank"} <= shipped
