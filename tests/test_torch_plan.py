"""The port's plan layer (guard_tpu_torch/ops/plan.py) and its verifier
(guard_tpu_torch/analysis/verify.py, signatures.py), case by case
against the JAX package's suites tests/test_plan_cache.py and
tests/test_plan_verify.py, and against the JAX package itself:

* the cache key changes with one rule byte, the file order and every
  environment axis (the card's name and count among them), ignores file
  names, and is domain-separated from the JAX package's;
* bit tables extended over a relocation equal direct lowering, and equal
  the JAX plan's after the same relocation;
* a disk round trip skips lowering; the artifact stays
  corpus-independent; corrupt, mismatched and foreign artifacts (the JAX
  package's among them) are misses, and a foreign one imports nothing;
  an unwritable directory warns;
* `validate` with the plan cold, warm, from disk and off prints what
  the JAX package prints, in every output format;
* every seeded mutation comes back under its named invariant; a fresh
  miscompile and a bad relocation are hard errors (rc 5);
* the relocation of the shared encode's per-bucket batches remaps every
  id column once, and the relocated batches evaluate as direct lowering
  does.
"""

import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from guard_tpu.ops import plan as jax_plan
from guard_tpu_torch.analysis import analysis_stats, reset_analysis_stats
from guard_tpu_torch.analysis.verify import (
    INVARIANTS,
    PlanVerifyError,
    _walk_compiled,
    first_violation_name,
    verify_plan,
    verify_relocation,
)
from guard_tpu_torch.commands.validate import RuleFile
from guard_tpu_torch.core.parser import parse_rules_file
from guard_tpu_torch.core.values import from_plain
from guard_tpu_torch.ops import plan as plan_mod
from guard_tpu_torch.ops.encoder import Interner, encode_batch, encode_bucketed
from guard_tpu_torch.ops.ir import StepKeyChain, compile_rules_file, extend_bit_tables
from test_torch_reports import run_jax, run_port

ROOT = Path(__file__).resolve().parent.parent

# the nested literal path Properties.Enc folds into a StepKeyChain, so
# the chain invariants are live on this registry
RULES_A = (
    "let b = Resources.*[ Type == 'AWS::S3::Bucket' ]\n"
    "rule sse when %b !empty { %b.Properties.Enc == true }\n"
)
RULES_B = (
    "rule named { Resources.*.Properties.Name in ['web', 'db'] }\n"
    "rule arnish { Resources.*.Properties.Arn == /^arn:aws:/ }\n"
)
# a function variable: the file is excluded from packing, and encodes
# and lowers per run against the plan interner
RULES_FN = (
    "let upper = to_upper(Resources.*.Type)\n"
    "rule named when Resources exists { %upper !empty }\n"
)
RULES_T = (
    "rule typed {\n"
    "    Resources.*.Type == 'AWS::S3::Bucket'\n"
    "    Resources.*.Properties.Enc == true\n"
    "}\n"
)


def _rule_file(content: str, name: str = "r.guard", pkg=None) -> RuleFile:
    if pkg == "jax":
        from guard_tpu.commands.validate import RuleFile as JaxRuleFile
        from guard_tpu.core.parser import parse_rules_file as jax_parse

        return JaxRuleFile(name=name, full_name=name, content=content,
                           rules=jax_parse(content, name))
    return RuleFile(name=name, full_name=name, content=content,
                    rules=parse_rules_file(content, name))


@pytest.fixture(autouse=True)
def _fresh_plan_state(tmp_path, monkeypatch):
    """Each test gets an empty memo and its own artifact directory; the
    JAX side is computed (no result cache, serial ingest)."""
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    plan_mod.clear_plan_memo()
    plan_mod.reset_plan_stats()
    reset_analysis_stats()
    yield
    plan_mod.clear_plan_memo()
    plan_mod.reset_plan_stats()
    reset_analysis_stats()


def _build():
    return plan_mod.get_plan([_rule_file(RULES_A, "a.guard"),
                              _rule_file(RULES_B, "b.guard")], device="cpu")


def _doc(name="web"):
    return {"Resources": {"x": {"Type": "AWS::S3::Bucket",
                                "Properties": {"Enc": True, "Name": name}}}}


def _relocate(plan, doc=None):
    chunk = Interner()
    batch, _ = encode_batch([from_plain(doc or _doc())], chunk)
    plan_mod.relocate_batch(plan, [batch], chunk)
    return batch


def _names(violations):
    return {v.invariant for v in violations}


def _pack_chain(compiled):
    found = []
    _walk_compiled(compiled, lambda s: isinstance(s, StepKeyChain) and found.append(s),
                   lambda n: None)
    assert found, "fixture rules must fold at least one key chain"
    return found[0]


# -- the cache key ------------------------------------------------------
def test_plan_key_changes_with_one_rule_byte():
    rf = _rule_file(RULES_A)
    tweaked = _rule_file(RULES_A.replace("true", "false"))
    assert plan_mod.plan_key([rf], device="cpu") != plan_mod.plan_key([tweaked], device="cpu")
    assert plan_mod.plan_key([rf], device="cpu") == plan_mod.plan_key(
        [_rule_file(RULES_A)], device="cpu")


def test_plan_key_ignores_file_names():
    a = _rule_file(RULES_A, name="one.guard")
    b = _rule_file(RULES_A, name="two.guard")
    assert plan_mod.plan_key([a], device="cpu") == plan_mod.plan_key([b], device="cpu")


def test_plan_key_covers_file_order():
    a, b = _rule_file(RULES_A), _rule_file(RULES_B)
    assert plan_mod.plan_key([a, b], device="cpu") != plan_mod.plan_key([b, a], device="cpu")


def test_plan_key_sensitive_to_every_environment_axis():
    rf = _rule_file(RULES_A)
    card = "cuda:NVIDIA H100 80GB HBM3"
    base = plan_mod.plan_key([rf], device_kind=card, device_count=1)
    for other in (
        dict(device_kind="cpu", device_count=1),
        dict(device_kind="cuda:NVIDIA H100 PCIe", device_count=1),
        dict(device_kind=card, device_count=4),
        dict(device_kind=card, device_count=1,
             schema_version=plan_mod.PLAN_SCHEMA_VERSION + 1),
        dict(device_kind=card, device_count=1, buckets=(64, 256)),
        dict(device_kind=card, device_count=1, pack_max_rules=7),
    ):
        assert base != plan_mod.plan_key([rf], **other), other


def test_plan_key_is_domain_separated_from_jax():
    """The same bytes under the same environment never give the JAX
    package's digest: neither package can load the other's artifact by
    name."""
    port = plan_mod.plan_key([_rule_file(RULES_A)], device_kind="cpu", device_count=1)
    jax = jax_plan.plan_key([_rule_file(RULES_A, pkg="jax")], device_kind="cpu",
                            device_count=1)
    assert port != jax


def test_device_fingerprint_and_default_dir(monkeypatch, tmp_path):
    assert plan_mod._device_fingerprint("cpu") == ("cpu", 1)
    monkeypatch.delenv("GUARD_TPU_PLAN_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert plan_mod.plan_cache_dir() == tmp_path / ".cache" / "guard_tpu_torch" / "plans"
    assert plan_mod.plan_cache_dir() != jax_plan.plan_cache_dir()


# -- extension against direct lowering -------------------------------------
def test_extend_bit_tables_matches_direct_lowering():
    rules = parse_rules_file(RULES_B, "r.guard")
    corpus = ["web", "db", "worker", "arn:aws:s3:::b1", "arn:gcp:thing", ""]
    direct_int = Interner()
    for s in corpus:
        direct_int.intern(s)
    direct = compile_rules_file(rules, direct_int)
    plan_int = Interner()
    lazy = compile_rules_file(rules, plan_int)
    assert all(len(t) == 0 for t, _tg in lazy.bit_tables)
    for s in corpus:
        plan_int.intern(s)
    extend_bit_tables([lazy], plan_int)
    assert len(lazy.bit_tables) == len(direct.bit_tables) == len(lazy.bit_specs)
    for (lt, ltg), (dt, dtg) in zip(lazy.bit_tables, direct.bit_tables):
        assert ltg == dtg
        np.testing.assert_array_equal(lt, dt)
    np.testing.assert_array_equal(lazy.str_empty_bits, direct.str_empty_bits)


def test_extend_bit_tables_grows_shared_arrays_once():
    from guard_tpu_torch.ops.ir import pack_compiled

    interner = Interner()
    a = compile_rules_file(parse_rules_file(RULES_A, "a"), interner)
    b = compile_rules_file(parse_rules_file(RULES_B, "b"), interner)
    packed = pack_compiled([a, b])
    for s in ("web", "db", "arn:aws:x", ""):
        interner.intern(s)
    extend_bit_tables([a, b, packed.compiled], interner)
    n = len(interner.strings)
    for comp in (a, b, packed.compiled):
        assert all(len(t) == n for t, _tg in comp.bit_tables)
        assert len(comp.str_empty_bits) == n
    part_tables = [t for t, _tg in a.bit_tables + b.bit_tables]
    for pt, _tg in packed.compiled.bit_tables:
        assert any(pt is t for t in part_tables)
    assert extend_bit_tables([a, b, packed.compiled], interner) == 0


def test_relocated_plan_equals_jax_plan(monkeypatch, tmp_path):
    """The port's plan and the JAX package's, built from the same bytes
    and relocated over the same documents: the same interner, packs and
    bit tables, byte for byte."""
    from guard_tpu.core.values import from_plain as jax_from_plain
    from guard_tpu.ops.encoder import Interner as JaxInterner
    from guard_tpu.ops.encoder import encode_batch as jax_encode

    texts = [(RULES_A, "a.guard"), (RULES_B, "b.guard"), (RULES_FN, "fn.guard")]
    port = plan_mod.get_plan([_rule_file(t, n) for t, n in texts], device="cpu")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "jax_plans"))
    jax_plan.clear_plan_memo()
    jax = jax_plan.get_plan([_rule_file(t, n, pkg="jax") for t, n in texts])
    docs = [_doc("web"), _doc("worker"), {"Resources": {"y": {"Properties": {
        "Arn": "arn:aws:s3:::b", "Name": "db"}}}}]
    chunk = Interner()
    batch, _ = encode_batch([from_plain(d) for d in docs], chunk)
    plan_mod.relocate_batch(port, [batch], chunk)
    jchunk = JaxInterner()
    jbatch, _ = jax_encode([jax_from_plain(d) for d in docs], jchunk)
    jax_plan.relocate_batch(jax, jbatch, jchunk)
    jax_plan.clear_plan_memo()
    assert port.interner.strings == jax.interner.strings
    assert port.slow == jax.slow == [2]
    assert [pos for pos, _p, _s in port.packs] == [pos for pos, _p, _s in jax.packs]
    for mine, theirs in zip(port.all_compiled(), jax.all_compiled()):
        assert len(mine.bit_tables) == len(theirs.bit_tables)
        for (mt, mtg), (tt, ttg) in zip(mine.bit_tables, theirs.bit_tables):
            assert mtg == ttg and mt.tobytes() == tt.tobytes()
    for col in ("scalar_id", "node_key_id", "edge_key_id"):
        np.testing.assert_array_equal(getattr(batch, col), getattr(jbatch, col))


# -- disk artifacts ------------------------------------------------------
def test_disk_roundtrip_skips_lowering(monkeypatch):
    rfs = [_rule_file(RULES_A), _rule_file(RULES_B)]
    plan_mod.get_plan(rfs, device="cpu")
    stats = plan_mod.plan_stats()
    assert stats["misses"] == 1 and stats["artifacts_saved"] == 1
    assert len(list(plan_mod.plan_cache_dir().glob("*.plan"))) == 1
    plan_mod.clear_plan_memo()
    plan_mod.reset_plan_stats()

    def _boom(_rfs):
        raise AssertionError("warm cache must not rebuild")

    monkeypatch.setattr(plan_mod, "build_plan", _boom)
    plan = plan_mod.get_plan([_rule_file(RULES_A), _rule_file(RULES_B)], device="cpu")
    stats = plan_mod.plan_stats()
    assert stats["hits"] == 1 and stats["misses"] == 0 and stats["bytes_loaded"] > 0
    assert len(plan.interner.strings) == 0
    assert all(len(t) == 0 for c in plan.all_compiled() for t, _tg in c.bit_tables)


def test_saved_artifact_stays_corpus_independent():
    plan = plan_mod.get_plan([_rule_file(RULES_B)], device="cpu")
    _relocate(plan)
    assert len(plan.interner.strings) > 0
    reloaded = plan_mod.load_plan(plan.digest)
    assert reloaded is not None and len(reloaded.interner.strings) == 0


def test_corrupt_artifact_degrades_to_miss(caplog):
    plan_mod.get_plan([_rule_file(RULES_A)], device="cpu")
    art = next(plan_mod.plan_cache_dir().glob("*.plan"))
    art.write_bytes(b"\x00garbage, not a pickle")
    plan_mod.clear_plan_memo()
    plan_mod.reset_plan_stats()
    with caplog.at_level("WARNING", logger="guard_tpu_torch.plan"):
        plan = plan_mod.get_plan([_rule_file(RULES_A)], device="cpu")
    stats = plan_mod.plan_stats()
    assert stats["misses"] == 1 and stats["hits"] == 0 and stats["corrupt_unreadable"] == 1
    assert any("treating as a cache miss" in r.message for r in caplog.records)
    assert plan_mod.load_plan(plan.digest) is not None  # rewritten


@pytest.mark.parametrize("mutate", [
    lambda p: {**p, "schema": p["schema"] + 1},
    lambda p: {**p, "version": "0.0.0-other"},
    lambda p: {**p, "digest": "0" * 64},
    lambda p: ["not", "a", "dict"],
], ids=["schema", "version", "digest", "not_a_dict"])
def test_mismatched_artifact_payloads_are_misses(mutate, caplog):
    plan = plan_mod.get_plan([_rule_file(RULES_A)], device="cpu")
    art = plan_mod._artifact_path(plan.digest)
    payload = pickle.loads(art.read_bytes())
    art.write_bytes(pickle.dumps(mutate(payload)))
    with caplog.at_level("WARNING", logger="guard_tpu_torch.plan"):
        assert plan_mod.load_plan(plan.digest) is None
    assert plan_mod.plan_stats()["corrupt_version_mismatch"] == 1


def test_unwritable_cache_dir_warns_and_continues(monkeypatch, caplog, tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the cache dir should be")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(blocker))
    with caplog.at_level("WARNING", logger="guard_tpu_torch.plan"):
        plan = plan_mod.get_plan([_rule_file(RULES_A)], device="cpu")
    assert plan is not None
    assert plan_mod.plan_stats()["artifacts_saved"] == 0
    assert any("save failed" in r.message for r in caplog.records)


def test_store_write_fault_downgrades_to_no_persistence(monkeypatch):
    from guard_tpu_torch.utils import faults

    monkeypatch.setenv("GUARD_TPU_FAULT", "store_write:nth=1")
    faults.reset_faults()
    try:
        plan = plan_mod.get_plan([_rule_file(RULES_A)], device="cpu")
        assert plan is not None
        assert plan_mod.plan_stats()["artifacts_saved"] == 0
        assert faults.FAULT_COUNTERS["injected_store_write"] == 1
        assert not list(plan_mod.plan_cache_dir().glob("*.plan"))
    finally:
        monkeypatch.delenv("GUARD_TPU_FAULT")
        faults.reset_faults()


def test_foreign_class_in_artifact_is_refused(caplog):
    """An artifact naming a module outside the port, numpy and the
    builtin containers is unreadable: nothing it names is resolved."""
    plan = plan_mod.get_plan([_rule_file(RULES_A)], device="cpu")
    art = plan_mod._artifact_path(plan.digest)
    art.write_bytes(pickle.dumps({"schema": 1, "plan": os.getcwd}))
    with caplog.at_level("WARNING", logger="guard_tpu_torch.plan"):
        assert plan_mod.load_plan(plan.digest) is None
    assert plan_mod.plan_stats()["corrupt_unreadable"] == 1
    assert any("cause=unreadable" in r.getMessage() and "posix" in r.getMessage()
               for r in caplog.records)


_FOREIGN = r"""
import json, sys
from guard_tpu_torch import cli
from guard_tpu_torch.ops import plan
from guard_tpu_torch.utils.io import Writer
w = Writer.buffered()
rc = cli.run(["validate", "--device", "cpu", "-S", "all", "-r", sys.argv[1], "-d", sys.argv[2]],
             writer=w)
print(json.dumps({"rc": rc, "out": w.stripped(), "stats": plan.plan_stats(),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "guard_tpu"))}))
"""


def test_jax_artifact_in_port_dir_is_a_miss_and_imports_nothing(monkeypatch, tmp_path):
    """A JAX artifact at the port's digest (a shared cache directory, a
    renamed file) is refused as unreadable: a port process neither loads
    it nor imports guard_tpu or jax for it."""
    rules = tmp_path / "r.guard"
    rules.write_text(RULES_A)
    data = tmp_path / "data"
    data.mkdir()
    (data / "d.json").write_text(json.dumps(_doc()))
    jax_dir = tmp_path / "jax_plans"
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(jax_dir))
    jax_plan.clear_plan_memo()
    jax_plan.get_plan([_rule_file(RULES_A, "r.guard", pkg="jax")])
    jax_plan.clear_plan_memo()
    (jax_art,) = jax_dir.glob("*.plan")
    port_dir = tmp_path / "port_plans"
    port_dir.mkdir()
    digest = plan_mod.plan_key([_rule_file(RULES_A, "r.guard")], device="cpu")
    (port_dir / f"{digest}.plan").write_bytes(jax_art.read_bytes())
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(GUARD_TPU_PLAN_CACHE_DIR=str(port_dir), PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _FOREIGN, str(rules), str(data)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["modules"] == []
    assert got["rc"] == 0 and "d.json Status = PASS" in got["out"]
    stats = got["stats"]
    assert stats["corrupt_unreadable"] == 1 and stats["misses"] == 1 and stats["hits"] == 0
    assert "cause=unreadable" in proc.stderr and "guard_tpu.ops.plan" in proc.stderr
    # the rebuild wrote the port's own artifact over it
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(port_dir))
    assert plan_mod.load_plan(digest) is not None


# -- parity gates: validate against the JAX package -----------------------
def _mk_corpus(tmp_path, n=8, fail=(2,), extra_rules=()):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    rule_paths = []
    for i, content in enumerate((RULES_A,) + tuple(extra_rules)):
        p = tmp_path / f"rules{i}.guard"
        p.write_text(content)
        rule_paths.append(str(p))
    for i in range(n):
        doc = {"Resources": {f"b{i}": {"Type": "AWS::S3::Bucket", "Properties": {
            "Enc": i not in fail, "Name": "web" if i % 2 else "worker",
            "Arn": f"arn:aws:s3:::b{i}"}}}}
        (data / f"t{i:02d}.json").write_text(json.dumps(doc))
    return ["-r", *rule_paths, "-d", str(data)]


def _port(args, tmp_path):
    os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp_path / "plans")
    return run_port(args)


def _jax(args, tmp_path):
    os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp_path / "jax_plans")
    try:
        return run_jax(args)
    finally:
        os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp_path / "plans")


@pytest.mark.parametrize("fmt", ["single-line-summary", "json", "yaml", "junit", "sarif"])
def test_validate_output_modes_parity(tmp_path, fmt):
    """Cold plan, warm (memo) plan, a plan from disk and --no-plan-cache
    print what the JAX package prints; the fn-var file takes the slow
    path under the plan."""
    args = _mk_corpus(tmp_path, n=6, fail=(1, 4), extra_rules=(RULES_B, RULES_FN))
    args += ["-o", fmt] + (["-z", "-S", "none"] if fmt != "single-line-summary" else [])
    want = _jax(args, tmp_path)
    cold, ev = _port(args, tmp_path)
    assert ev.packs == [(0, 1)]
    assert plan_mod.plan_stats()["misses"] == 1
    warm, _ = _port(args, tmp_path)
    assert plan_mod.plan_stats()["hits"] == 1
    plan_mod.clear_plan_memo()
    disk, _ = _port(args, tmp_path)
    assert plan_mod.plan_stats()["hits"] == 2 and plan_mod.plan_stats()["bytes_loaded"] > 0
    legacy, ev = _port(args + ["--no-plan-cache"], tmp_path)
    assert ev.packs == [(0, 1)]
    assert cold == warm == disk == legacy == want
    assert want[0] == 19


def test_escape_hatch_disables_layer(tmp_path, monkeypatch):
    args = _mk_corpus(tmp_path, n=4, fail=(0,), extra_rules=(RULES_B,))
    off, _ = _port(args + ["--no-plan-cache"], tmp_path)
    stats = plan_mod.plan_stats()
    assert stats["hits"] == stats["misses"] == stats["relocations"] == 0
    assert not list(plan_mod.plan_cache_dir().glob("*.plan"))
    on, _ = _port(args, tmp_path)
    assert off == on and plan_mod.plan_stats()["misses"] == 1


def test_no_verify_plans_flag(tmp_path, monkeypatch):
    args = _mk_corpus(tmp_path, n=4, fail=(0,), extra_rules=(RULES_B,))
    base, _ = _port(args, tmp_path)
    checked = analysis_stats()["invariants_checked"]
    assert checked > 0
    plan_mod.clear_plan_memo()
    got, _ = _port(args + ["--no-verify-plans"], tmp_path)
    assert got == base and analysis_stats()["invariants_checked"] == checked


def test_fresh_miscompile_exits_5(tmp_path, monkeypatch):
    """A plan that fails verification straight out of its build stops
    the run with the verifier's named diagnostic, rc 5."""
    args = _mk_corpus(tmp_path, n=3, extra_rules=(RULES_B,))
    real_build = plan_mod.build_plan

    def sabotaged(rule_files):
        plan = real_build(rule_files)
        plan.packs[0][1].offsets[0] += 1
        return plan

    monkeypatch.setattr(plan_mod, "build_plan", sabotaged)
    (rc, out, err), ev = _port(args, tmp_path)
    assert rc == 5 and out == "" and ev is None
    assert "plan verification failed: segment_offsets_consistent" in err


# -- the verifier: healthy plans ----------------------------------------------
def test_fresh_plan_verifies_clean():
    plan = _build()
    assert verify_plan(plan) == []
    stats = analysis_stats()
    assert stats["invariants_checked"] > 0 and stats["violations"] == 0


def test_relocated_plan_verifies_clean():
    plan = _build()
    batch = _relocate(plan)
    assert verify_plan(plan) == []
    assert verify_relocation(plan, batch) == []


def _corpus_rule_files(pkg=None):
    out = []
    for p in sorted((ROOT / "corpus" / "rules").glob("*.guard")):
        out.append(_rule_file(p.read_text(), p.name, pkg))
    return out


def test_full_corpus_plan_verifies_clean():
    rule_files = _corpus_rule_files()
    assert len(rule_files) > 100
    plan = plan_mod.build_plan(rule_files)
    assert verify_plan(plan) == []
    assert [len(pos) for pos, _p, _s in plan.packs] == [245]
    assert len(plan.packs[0][1].compiled.rules) == 253
    batch = _relocate(plan)
    assert verify_plan(plan) == []
    assert verify_relocation(plan, batch) == []


def test_invariants_are_the_jax_packages():
    from guard_tpu.analysis.verify import INVARIANTS as JAX_INVARIANTS

    assert INVARIANTS == JAX_INVARIANTS


# -- the verifier: seeded mutations -----------------------------------------
def _mut_swapped_offsets(plan):
    packed = plan.packs[0][1]
    packed.offsets[0], packed.offsets[1] = packed.offsets[1], packed.offsets[0]


def _mut_off_by_one_chain(plan):
    _pack_chain(plan.packs[0][1].compiled).chain_slot += 1


def _mut_chain_spec_drift(plan):
    comp = plan.packs[0][1].compiled
    slot = _pack_chain(comp).chain_slot
    spec = comp.chain_tables[slot]
    comp.chain_tables[slot] = ((("NotTheKey",), spec[0][1]),) + tuple(spec[1:])


def _mut_rim_drift(plan):
    spec = plan.packs[0][2]
    spec.group_ids = np.roll(spec.group_ids, 1)


def _mut_dangling_slot(plan):
    part = plan.packs[0][1].compiled
    part.bit_tables = []
    part.bit_specs = []


MUTATIONS = {
    "swapped_segment_offsets": (_mut_swapped_offsets, "segment_offsets_consistent"),
    "off_by_one_chain_slot": (_mut_off_by_one_chain, "anchor_chain_domains"),
    "chain_spec_drift": (_mut_chain_spec_drift, "anchor_chain_domains"),
    "rim_spec_drift": (_mut_rim_drift, "rim_name_group_coverage"),
    "dangling_slot_reference": (_mut_dangling_slot, "slot_relocation_bijective"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_names_its_invariant(case):
    mutate, invariant = MUTATIONS[case]
    plan = _build()
    assert len(plan.packs[0][1].offsets) >= 2
    mutate(plan)
    violations = verify_plan(plan)
    assert invariant in _names(violations)
    assert all(v.invariant in INVARIANTS for v in violations)


def test_mutation_truncated_bit_table():
    plan = _build()
    batch = _relocate(plan)
    part = plan.packs[0][1].compiled
    assert part.bit_tables and len(part.bit_tables[0][0]) > 0
    table, target = part.bit_tables[0]
    part.bit_tables[0] = (table[:-1], target)
    assert "bit_table_width" in _names(verify_plan(plan))
    assert "bit_table_width" in _names(verify_relocation(plan, batch))


def test_mutation_stale_intern_ids():
    plan = _build()
    batch = _relocate(plan)
    batch.scalar_id = batch.scalar_id.copy()
    batch.scalar_id.flat[0] = len(plan.interner.strings) + 7
    assert _names(verify_relocation(plan, batch)) == {"intern_id_domain"}


def test_every_emitted_name_is_catalogued():
    plan = _build()
    plan.packs[0][1].offsets[0] += 1
    for v in verify_plan(plan):
        assert v.invariant in INVARIANTS
    assert first_violation_name([]) is None


# -- the verifier: policy hooks ----------------------------------------------
def _corrupt_saved_artifact(plan):
    art = plan_mod._artifact_path(plan.digest)
    payload = pickle.loads(art.read_bytes())
    _pack_chain(payload["plan"].packs[0][1].compiled).chain_slot += 1
    art.write_bytes(pickle.dumps(payload))


def test_corrupt_artifact_load_is_named_miss(caplog):
    plan = _build()
    _corrupt_saved_artifact(plan)
    plan_mod.clear_plan_memo()
    plan_mod.reset_plan_stats()
    with caplog.at_level("WARNING", logger="guard_tpu_torch.plan"):
        assert plan_mod.load_plan(plan.digest) is None
    assert any("cause=verify:anchor_chain_domains" in r.getMessage() for r in caplog.records)
    assert plan_mod.plan_stats()["corrupt_verify"] == 1
    rebuilt = _build()
    assert verify_plan(rebuilt) == []
    assert plan_mod.plan_stats()["misses"] == 1


def test_corrupt_artifact_load_skipped_when_disabled(monkeypatch):
    plan = _build()
    _corrupt_saved_artifact(plan)
    plan_mod.clear_plan_memo()
    assert plan_mod.load_plan(plan.digest) is None
    assert plan_mod.load_plan(plan.digest, verify=False) is not None


def test_fresh_lowering_violation_is_hard_error(monkeypatch):
    real_build = plan_mod.build_plan

    def sabotaged(rule_files):
        plan = real_build(rule_files)
        plan.packs[0][1].offsets[0] += 1
        return plan

    monkeypatch.setattr(plan_mod, "build_plan", sabotaged)
    with pytest.raises(PlanVerifyError) as ei:
        _build()
    assert "segment_offsets_consistent" in str(ei.value) and ei.value.violations


def test_relocation_violation_is_hard_error():
    plan = _build()
    chunk = Interner()
    batch, _ = encode_batch([from_plain(_doc())], chunk)
    with pytest.raises(PlanVerifyError) as ei:
        plan_mod.relocate_batch(plan, [batch], Interner())  # wrong interner
    assert "intern_id_domain" in str(ei.value)


# -- signatures ----------------------------------------------------------------
def test_signatures_round_trip_through_artifact():
    rfs = [_rule_file(RULES_T, "t.guard"), _rule_file(RULES_B, "b.guard")]
    plan = plan_mod.get_plan(rfs, device="cpu")
    sigs = plan.signatures
    assert len(sigs.files) == 2
    assert "AWS::S3::Bucket" in sigs.files[0].type_equalities
    assert ("Resources",) in sigs.files[1].key_chains
    assert sigs.files[0].unanchored_rules == 0
    plan_mod.clear_plan_memo()
    reloaded = plan_mod.get_plan([_rule_file(RULES_T, "t.guard"),
                                  _rule_file(RULES_B, "b.guard")], device="cpu")
    assert plan_mod.plan_stats()["hits"] == 1
    assert reloaded.signatures.files[0].to_json() == sigs.files[0].to_json()
    doc = json.loads((plan_mod.plan_cache_dir() / f"{plan.digest}.sigs.json").read_text())
    assert doc["digest"] == plan.digest
    assert doc["packs"] and doc["packs"][0]["members"] == [0, 1]
    assert doc["packs"][0]["type_equalities"]


def test_corpus_signatures_equal_jax():
    from guard_tpu.analysis.signatures import extract_plan_signatures as jax_extract
    from guard_tpu_torch.analysis.signatures import extract_plan_signatures

    mine = extract_plan_signatures(_corpus_rule_files())
    theirs = jax_extract(_corpus_rule_files("jax"))
    assert mine.schema == theirs.schema
    assert [None if s is None else s.to_json() for s in mine.files] == [
        None if s is None else s.to_json() for s in theirs.files
    ]


# -- relocation of the per-bucket shared encode -----------------------------------
def _xref_docs(n=24):
    from guard_tpu_torch.workloads import example_docs, make_xref_template

    rng = np.random.default_rng(4)
    return [make_xref_template(rng, i) for i in range(n)] + example_docs(6, two_buckets=True)


def test_bucket_batches_hold_their_own_id_columns():
    """No id column of one bucket's batch shares memory with another's
    (a shared column would be remapped twice), from the tree encoder and
    from a merge of shards."""
    from guard_tpu_torch.ops.encoder import merge_bucket_groups, remap_interned_ids

    docs = [from_plain(d) for d in _xref_docs()]
    groups, _over, interner = encode_bucketed(docs)
    assert len(groups) >= 2
    shard_a, _oa, ia = encode_bucketed(docs[:10])
    shard_b, _ob, ib = encode_bucketed(docs[10:])
    merged_int = Interner()
    for sh, si in ((shard_a, ia), (shard_b, ib)):
        remap = np.array([merged_int.intern(s) for s in si.strings], np.int32)
        for b, _i in sh:
            remap_interned_ids(b, remap)
    merged, _over = merge_bucket_groups([(shard_a, _oa, 0), (shard_b, _ob, 10)])
    for gs in (groups, merged):
        cols = [getattr(b, c) for b, _i in gs
                for c in ("scalar_id", "edge_key_id", "node_key_id")]
        for i, a in enumerate(cols):
            for b in cols[i + 1:]:
                assert not np.shares_memory(a, b)


def test_relocation_remaps_a_listed_batch_once():
    plan = _build()
    chunk = Interner()
    batch, _ = encode_batch([from_plain(_doc("db"))], chunk)
    before = batch.scalar_id.copy()
    plan_mod.relocate_batch(plan, [batch, batch], chunk)
    remap = np.array([plan.interner.lookup(s) for s in chunk.strings])
    np.testing.assert_array_equal(batch.scalar_id,
                                  np.where(before >= 0, remap[np.maximum(before, 0)], before))


def test_relocated_buckets_evaluate_as_direct_lowering():
    """The xref policy (struct ids, query-RHS compares) over documents in
    two buckets: the shared encode relocated into a plan — its struct
    ids computed before the relocation — evaluates to the statuses,
    unsure bits and rim blocks of lowering against the encode itself,
    packed or not."""
    from guard_tpu_torch.ops.backend import evaluate
    from guard_tpu_torch.workloads import XREF_RULES

    rule_files = [_rule_file(XREF_RULES, "xref.guard"), _rule_file(RULES_B, "b.guard"),
                  _rule_file(RULES_T, "t.guard")]
    docs = [from_plain(d) for d in _xref_docs()]
    direct = evaluate(rule_files, docs, "cpu", plan_cache=False, pack_rules=False)
    shared = encode_bucketed(docs)
    for b, _i in shared[0]:
        b.struct_ids()  # cached under the encode's ids
    planned = evaluate(rule_files, docs, "cpu", shared=shared)
    assert planned.packs == [(0, 1, 2)]
    assert planned.interner is plan_mod.get_plan(rule_files, device=torch_cpu()).interner
    for fr, dr in zip(planned.files, direct.files):
        np.testing.assert_array_equal(fr.statuses, dr.statuses)
        np.testing.assert_array_equal(fr.unsure, dr.unsure)
        assert fr.host_docs == dr.host_docs
        for a, b in zip(fr.rim, dr.rim):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert any(fr.unsure.any() or (fr.statuses == 1).any() for fr in planned.files)


def torch_cpu():
    import torch

    return torch.device("cpu")


# -- the boundaries ---------------------------------------------------------------
PLAN_MODULES = (
    "guard_tpu_torch/ops/plan.py",
    "guard_tpu_torch/analysis/__init__.py",
    "guard_tpu_torch/analysis/verify.py",
    "guard_tpu_torch/analysis/signatures.py",
    "guard_tpu_torch/ops/backend.py",
    "guard_tpu_torch/parallel/device.py",
)
_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|guard_tpu)(?:[.\s,]|$)", re.M)


@pytest.mark.parametrize("module", PLAN_MODULES)
def test_module_imports_no_jax(module):
    assert not _IMPORT.search((ROOT / module).read_text())
