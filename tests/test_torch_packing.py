"""Fused multi-rule-file dispatch in the port (ops/backend.plan_packs,
dispatch_packs, collect_packs) against its per-file path and against
the JAX package's packing, case by case after tests/test_rule_packing.py.

The packed path must be bit-identical to the per-file path — statuses,
unsure bits, rim blocks, the documents left to the oracle — while
issuing one walk per (pack, bucket) where the per-file path issues one
per (file, bucket). Against the JAX package: the same pack plan, the
same statuses on every cell neither package flags unsure, the raw
statuses and unsure bits of a gather-forced JAX run in a subprocess
(GUARD_TPU_GATHER_CPU_MIN_NODES=0: below 32 nodes the JAX package's
one-hot arm decides list-in-subset pairs the gather arm, which the
port follows, flags unsure), and `validate`'s stdout bytes and rc over
a registry directory packed, with --no-pack, with --no-plan-cache and
on a warm plan cache. No tolerance anywhere.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import yaml

import bench
from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu.ops.backend import _evaluate_packs as j_evaluate_packs
from guard_tpu.ops.backend import plan_packs as j_plan_packs
from guard_tpu.ops.encoder import encode_batch as j_encode
from guard_tpu.ops.ir import compile_rules_file as j_compile
from guard_tpu.ops.ir import pack_compatible as j_pack_compatible
from guard_tpu_torch.core.parser import parse_rules_file
from guard_tpu_torch.core.values import from_plain
from guard_tpu_torch.ops import backend
from guard_tpu_torch.ops import plan as plan_mod
from guard_tpu_torch.ops.backend import _evaluate_packs, plan_packs
from guard_tpu_torch.ops.encoder import encode_bucketed
from guard_tpu_torch.ops.ir import (
    PackIncompatible,
    build_rim_spec,
    compile_rules_file,
    pack_compatible,
    pack_compiled,
)
from guard_tpu_torch.parallel.device import (
    DISPATCH_COUNTERS,
    EFFICIENCY_COUNTERS,
    DeviceBatchEvaluator,
    evaluate_groups,
)
from test_torch_reports import run_jax, run_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus" / "rules"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)
    plan_mod.clear_plan_memo()
    yield
    plan_mod.clear_plan_memo()


def corpus_slice(n_files, n_docs=32):
    """([(text, name)], plain docs) over the first n_files corpus rule
    files and the union of their own test inputs."""
    paths = sorted(CORPUS.glob("*.guard"))[:n_files]
    docs = []
    for p in paths:
        spec = CORPUS / "tests" / f"{p.stem}_tests.yaml"
        if spec.exists():
            for case in yaml.safe_load(spec.read_text()) or []:
                if isinstance(case, dict) and "input" in case:
                    docs.append(case["input"])
    return [(p.read_text(), p.name) for p in paths], docs[:n_docs]


def example_rules():
    return [(p.read_text(), p.name) for p in sorted(ROOT.glob("examples/rules/*/*.guard"))]


def port_packed_vs_perfile(rules, plain_docs):
    """Evaluate every packable file packed and per file on the port;
    require bit-identity of statuses, unsure bits, rim blocks and host
    documents. Returns (compiled, items, packed results)."""
    docs = [from_plain(d) for d in plain_docs]
    groups, oversize, interner = encode_bucketed(docs)
    compiled = [compile_rules_file(parse_rules_file(t, n), interner) for t, n in rules]
    items = [(fi, c) for fi, c in enumerate(compiled) if pack_compatible(c) is None]
    packed = _evaluate_packs(items, groups, len(docs), oversize, "cpu")
    assert set(packed) == {fi for fi, _ in items}
    for fi, c in items:
        ev = DeviceBatchEvaluator(c, "cpu", rim_spec=build_rim_spec([c.rules]))
        st, un, host, rim = evaluate_groups(ev, len(c.rules), groups, oversize, len(docs))
        pst, pun, phost, prim = packed[fi]
        np.testing.assert_array_equal(pst, st, err_msg=f"statuses of file {fi}")
        np.testing.assert_array_equal(pun, un, err_msg=f"unsure of file {fi}")
        assert phost == host
        for k, (a, b) in enumerate(zip(prim, rim)):
            assert a.dtype == b.dtype and a.shape == b.shape, (fi, k)
            np.testing.assert_array_equal(a, b, err_msg=f"rim block {k} of file {fi}")
    return compiled, items, packed


def jax_packed(rules, plain_docs):
    batch, interner = j_encode([j_from_plain(d) for d in plain_docs])
    compiled = [j_compile(j_parse(t, n), interner) for t, n in rules]
    items = [(fi, c) for fi, c in enumerate(compiled) if j_pack_compatible(c) is None]
    return items, j_evaluate_packs(items, batch)


def assert_decided_cells_match_jax(rules, plain_docs, packed):
    items, theirs = jax_packed(rules, plain_docs)
    assert set(theirs) == set(packed)
    decided = total = 0
    for fi in packed:
        st, un = packed[fi][:2]
        jst, jun = theirs[fi][:2]
        cells = ~un & ~jun
        np.testing.assert_array_equal(st[cells], jst[cells], err_msg=f"file {fi}")
        decided += int(cells.sum())
        total += cells.size
    assert decided >= 0.5 * total


def test_packed_parity_corpus_slice():
    rules, docs = corpus_slice(24)
    assert docs
    _c, items, packed = port_packed_vs_perfile(rules, docs)
    assert len(items) >= 20
    assert_decided_cells_match_jax(rules, docs, packed)


def test_packed_parity_examples():
    rng = np.random.default_rng(2)
    docs = [bench.make_template(rng, i) for i in range(12)]
    docs += [bench.make_config_item(rng, i) for i in range(6)]
    rules = example_rules()
    assert len(rules) >= 5
    _c, items, packed = port_packed_vs_perfile(rules, docs)
    assert len(items) >= 2
    assert_decided_cells_match_jax(rules, docs, packed)


def test_packed_parity_mixed_host_fallback():
    """A host-fallback-only file and a function-variable file route to
    the per-file path while their neighbours pack."""
    rng = np.random.default_rng(7)
    docs = [bench.make_template(rng, i) for i in range(8)]
    rules = [
        (bench.RULES, "a.guard"),
        ("rule host_now { Resources.created == now() }", "host.guard"),
        ("let upper = to_upper(Resources.*.Type)\n"
         "rule named when Resources exists { %upper !empty }", "fn.guard"),
        (bench.ENCRYPTION_RULES, "b.guard"),
    ]
    compiled, items, packed = port_packed_vs_perfile(rules, docs)
    assert compiled[1].host_rules, "now() should refuse lowering"
    assert [fi for fi, _ in items] == [0, 3]
    assert pack_compatible(compiled[2]) is not None
    assert_decided_cells_match_jax(rules, docs, packed)


def test_pack_incompatible_raises():
    rng = np.random.default_rng(9)
    docs = [from_plain(bench.make_template(rng, i)) for i in range(4)]
    _g, _o, interner = encode_bucketed(docs)
    ok = compile_rules_file(parse_rules_file(bench.RULES, "a.guard"), interner)
    bad = compile_rules_file(parse_rules_file(
        "let upper = to_upper(Resources.*.Type)\n"
        "rule named when Resources exists { %upper !empty }", "fn.guard"), interner)
    with pytest.raises(PackIncompatible):
        pack_compiled([ok, bad])
    other = compile_rules_file(parse_rules_file(bench.RULES, "c.guard"), type(interner)())
    with pytest.raises(PackIncompatible):
        pack_compiled([ok, other])


def test_plan_packs_respects_rule_ceiling():
    class _C:
        def __init__(self, n):
            self.rules = [None] * n

    items = [(i, _C(3)) for i in range(10)]
    packs = plan_packs(items, max_rules=9)
    assert [len(p) for p in packs] == [3, 3, 3, 1]
    assert [fi for p in packs for fi, _ in p] == list(range(10))
    assert [[fi for fi, _ in p] for p in packs] == [
        [fi for fi, _ in p] for p in j_plan_packs(items, max_rules=9)
    ]


def test_corpus_plans_into_one_pack_like_jax():
    """All 249 corpus files: 245 pack-compatible files in one pack of
    253 rules in both packages, the 4 with function variables left out."""
    from guard_tpu.ops.fnvars import precomputable_fn_vars as j_fn_vars
    from guard_tpu_torch.ops.fnvars import precomputable_fn_vars

    rules = [(p.read_text(), p.name) for p in sorted(CORPUS.glob("*.guard"))]
    _g, _o, interner = encode_bucketed([from_plain({})])
    parsed = [parse_rules_file(t, n) for t, n in rules]
    items = [(fi, compile_rules_file(rf, interner)) for fi, rf in enumerate(parsed)
             if not precomputable_fn_vars(rf)]
    items = [(fi, c) for fi, c in items if pack_compatible(c) is None]
    packs = plan_packs(items)
    _jb, ji = j_encode([j_from_plain({})])
    jparsed = [j_parse(t, n) for t, n in rules]
    jitems = [(fi, j_compile(rf, ji)) for fi, rf in enumerate(jparsed) if not j_fn_vars(rf)]
    jitems = [(fi, c) for fi, c in jitems if j_pack_compatible(c) is None]
    assert [[fi for fi, _ in p] for p in packs] == [
        [fi for fi, _ in p] for p in j_plan_packs(jitems)
    ]
    assert len(rules) == 249 and [len(p) for p in packs] == [245]
    assert sum(len(c.rules) for _fi, c in packs[0]) == 253


def test_packed_dispatch_counters_under_ceiling():
    """Over a 24-file corpus slice the packed path issues >= 10x fewer
    walks than the per-file path and fills its rule slots."""
    rules, plain = corpus_slice(24)
    docs = [from_plain(d) for d in plain]
    groups, oversize, interner = encode_bucketed(docs)
    compiled = [compile_rules_file(parse_rules_file(t, n), interner) for t, n in rules]
    items = [(fi, c) for fi, c in enumerate(compiled) if pack_compatible(c) is None]
    assert len(items) >= 20
    for key in EFFICIENCY_COUNTERS:
        EFFICIENCY_COUNTERS[key] = 0
    DISPATCH_COUNTERS["dispatches"] = 0
    _evaluate_packs(items, groups, len(docs), oversize, "cpu")
    packed = DISPATCH_COUNTERS["dispatches"]
    assert packed == len(groups)  # one pack, one walk per bucket
    assert EFFICIENCY_COUNTERS["pack_rule_slots_used"] == sum(len(c.rules) for _, c in items)
    assert EFFICIENCY_COUNTERS["pack_rule_slots_capacity"] == backend.PACK_MAX_RULES
    DISPATCH_COUNTERS["dispatches"] = 0
    for _, c in items:
        evaluate_groups(DeviceBatchEvaluator(c, "cpu"), len(c.rules), groups, oversize, len(docs))
    perfile = DISPATCH_COUNTERS["dispatches"]
    assert perfile == len(items) * len(groups)
    assert packed * 10 <= perfile and packed <= 8


# -- raw bits against a gather-forced JAX run -------------------------------------
_GATHER_SCRIPT = r"""
import json, sys
from guard_tpu.core.parser import parse_rules_file
from guard_tpu.core.values import from_plain
from guard_tpu.ops.backend import _evaluate_packs
from guard_tpu.ops.encoder import encode_batch
from guard_tpu.ops.ir import compile_rules_file, pack_compatible
rules, docs = json.load(sys.stdin)
batch, interner = encode_batch([from_plain(d) for d in docs])
compiled = [compile_rules_file(parse_rules_file(t, n), interner) for t, n in rules]
items = [(fi, c) for fi, c in enumerate(compiled) if pack_compatible(c) is None]
res = _evaluate_packs(items, batch)
print(json.dumps({str(fi): [r[0].tolist(), r[1].tolist(), [b.tolist() for b in r[3][:6]]]
                  for fi, r in res.items()}))
"""


@pytest.mark.parametrize("case", ["corpus_slice", "examples"])
def test_raw_bits_match_gather_forced_jax(case):
    if case == "corpus_slice":
        rules, docs = corpus_slice(24)
    else:
        rng = np.random.default_rng(2)
        docs = [bench.make_template(rng, i) for i in range(12)]
        rules = example_rules()
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "GUARD_TPU_GATHER_ON_CPU": "1",
                "GUARD_TPU_GATHER_CPU_MIN_NODES": "0", "PYTHONPATH": str(ROOT)})
    proc = subprocess.run([sys.executable, "-c", _GATHER_SCRIPT],
                          input=json.dumps([rules, docs]), capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout)
    _c, _items, packed = port_packed_vs_perfile(rules, docs)
    assert set(ref) == {str(fi) for fi in packed}
    for fi, (st, un, _host, rim) in packed.items():
        jst, jun, jrim = ref[str(fi)]
        np.testing.assert_array_equal(st, np.array(jst, np.int8).reshape(st.shape))
        np.testing.assert_array_equal(un, np.array(jun, bool).reshape(un.shape))
        # doc status, any-fail and any-unsure: the JAX slice is (D,), the
        # port's a (D, 1) column
        for k, (mine, theirs) in enumerate(zip(rim, jrim)):
            np.testing.assert_array_equal(
                mine, np.array(theirs, mine.dtype).reshape(mine.shape), err_msg=f"{fi} {k}")


# -- validate over a registry directory ---------------------------------------
def write_registry(root, n_files=12):
    """The first n_files corpus files and their test inputs (each
    written once) as a registry directory."""
    (root / "rules").mkdir()
    (root / "data").mkdir()
    k = 0
    for p in sorted(CORPUS.glob("*.guard"))[:n_files]:
        (root / "rules" / p.name).write_text(p.read_text())
        spec = CORPUS / "tests" / f"{p.stem}_tests.yaml"
        for case in yaml.safe_load(spec.read_text()) or []:
            if isinstance(case, dict) and "input" in case:
                (root / "data" / f"d{k:04d}.json").write_text(json.dumps(case["input"]))
                k += 1
    return ["-r", str(root / "rules"), "-d", str(root / "data")]


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return write_registry(tmp_path_factory.mktemp("registry"))


REGISTRY_FLAGS = {"show_all": ["-S", "all"], "structured_json": ["-z", "-o", "json", "-S", "none"]}
MODES = {"packed": [], "no_pack": ["--no-pack"], "no_plan_cache": ["--no-plan-cache"],
         "warm": []}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("flags", sorted(REGISTRY_FLAGS))
def test_registry_cli_matches_jax(registry, monkeypatch, tmp_path, flags, mode):
    """`validate` over a registry directory: the port's stdout and rc
    equal the JAX package's with the same flags, packed (one walk per
    bucket for the pack), with --no-pack (one per file and bucket), with
    --no-plan-cache, and on a warm plan cache (a disk hit)."""
    from test_torch_reports import set_native

    set_native(monkeypatch, None)
    args = registry + REGISTRY_FLAGS[flags] + MODES[mode]
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "jax_plans"))
    want = run_jax(args)
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "port_plans"))
    if mode == "warm":
        run_port(args)
        plan_mod.clear_plan_memo()
        plan_mod.reset_plan_stats()
    DISPATCH_COUNTERS["dispatches"] = 0
    got, ev = run_port(args)
    assert got[:2] == want[:2]
    assert got[0] == 19
    n_buckets = len(ev.groups)
    if mode == "no_pack":
        assert ev.packs == []
        assert DISPATCH_COUNTERS["dispatches"] == sum(
            len(fr.groups) for fr in ev.files if fr.compiled.rules)
    else:
        assert len(ev.packs) == 1 and len(ev.packs[0]) >= 10
        per_file = sum(len(fr.groups) for fr in ev.files
                       if fr.compiled.rules and fr.pack is None)
        assert DISPATCH_COUNTERS["dispatches"] == n_buckets + per_file
    if mode == "warm":
        assert plan_mod.plan_stats()["hits"] == 1 and plan_mod.plan_stats()["misses"] == 0


def test_packed_file_results_keep_the_per_file_shapes(registry, monkeypatch):
    """A packed file's rim blocks have the per-file path's shapes: name
    blocks (D, G_f), doc status and the two any-blocks (D, 1)."""
    from test_torch_reports import set_native

    set_native(monkeypatch, None)
    _got, packed = run_port(registry + ["--statuses-only"])
    _got, perfile = run_port(registry + ["--statuses-only", "--no-pack"])
    n_packed = 0
    for fr, br in zip(packed.files, perfile.files):
        n_packed += fr.pack is not None
        np.testing.assert_array_equal(fr.statuses, br.statuses)
        np.testing.assert_array_equal(fr.unsure, br.unsure)
        assert fr.names == br.names and fr.host_docs == br.host_docs
        for a, b in zip(fr.rim, br.rim):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert n_packed >= 10


_NO_JAX = r"""
import sys
from guard_tpu_torch import cli
from guard_tpu_torch.ops import plan
from guard_tpu_torch.utils.io import Writer
args = ["validate", "--device", "cpu", "--statuses-only", *sys.argv[1:]]
rcs = [cli.run(args, writer=Writer.buffered())]
plan.clear_plan_memo()
rcs.append(cli.run(args, writer=Writer.buffered()))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "guard_tpu"))
print(rcs, plan.plan_stats()["hits"], bad)
"""


def test_packed_and_warm_runs_import_no_jax(registry, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(GUARD_TPU_PLAN_CACHE_DIR=str(tmp_path / "plans"), PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *registry], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[19, 19] 1 []"
