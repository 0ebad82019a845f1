"""The port's kernel-vs-oracle differential fuzzer
(guard_tpu_torch/tools/kernel_fuzz.py) on the CPU, against the JAX
package's tools/kernel_fuzz.py.

  * The generator is the JAX tool's: for seeds 0-23 x 12 trials one
    `random.Random(seed)` draws the same rules text, tags, documents
    and big documents in both, and ends in the same state.
  * The CI tier's counterpart: seeds 11, 222 and 3333 x 30 trials on
    the CPU (the kernels' plain versions), the native oracle built into
    a temporary directory (leg (c)): no divergence, over 100 checked
    cells each; the tagged grammar covers ALL_TAGS; a corpus-seeded
    trial runs clean.
  * The port against the JAX package, seeds 1 and 2 x 8 trials: the
    port's statuses equal the JAX BatchEvaluator's on every cell
    neither flags unsure, and the port's CPU oracle equals the JAX
    oracle on every document.
  * An evaluator that flips one status is caught, by the trial and by
    `main`, which exits 1 and writes a reproducer that replays.
  * `main --device cpu` in a subprocess exits 0 with the summary line
    and imports no jax; with no card and no `--device` it exits 2 with
    a message naming `--device cpu`.
"""

import json
import os
import pathlib
import random
import re
import subprocess
import sys

import numpy as np
import pytest

from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.tools import kernel_fuzz as port_fuzz

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import kernel_fuzz as jax_fuzz  # noqa: E402

TRIALS = 30
real_make_evaluator = port_fuzz.make_evaluator


@pytest.fixture(scope="module")
def native_dir(tmp_path_factory):
    """The port's native oracle, built once into a temporary directory."""
    from guard_tpu_torch.ops import _native_lib, native_oracle

    d = tmp_path_factory.mktemp("kernel_fuzz_native")
    saved = _native_lib.NATIVE_DIR
    _native_lib.NATIVE_DIR = d
    try:
        native_oracle.build_native()
    finally:
        _native_lib.NATIVE_DIR = saved
    return d


@pytest.fixture
def native_on(monkeypatch, native_dir):
    from guard_tpu_torch.ops import _native_lib, native_oracle

    monkeypatch.setattr(_native_lib, "NATIVE_DIR", native_dir)
    monkeypatch.setattr(_native_lib, "_libs", {})
    monkeypatch.setattr(native_oracle, "_configured", None)
    monkeypatch.setattr(port_fuzz, "_native_cache", {})
    assert native_oracle.native_available()


# -- the generator ------------------------------------------------------
def test_generator_tables_match_the_jax_tool():
    for name in ("KEYS", "TYPES", "STRS", "NUMS", "ALL_TAGS", "STATUS"):
        assert getattr(port_fuzz, name) == getattr(jax_fuzz, name), name


@pytest.mark.parametrize("seed", range(24))
def test_generator_matches_the_jax_tool(seed):
    pr, jr = random.Random(seed), random.Random(seed)
    pt, jt = set(), set()
    for ti in range(12):
        assert port_fuzz.rand_rules(pr, ti, pt) == jax_fuzz.rand_rules(jr, ti, jt)
        assert pt == jt
        assert port_fuzz.rand_doc(pr) == jax_fuzz.rand_doc(jr)
        if ti % 4 == 3:
            assert port_fuzz.rand_big_doc(pr) == jax_fuzz.rand_big_doc(jr)
    assert pr.getstate() == jr.getstate()


def test_generator_covers_every_tagged_construct():
    """Across a fixed seed set the generator emits every construct
    family the kernels lower (ALL_TAGS)."""
    tags = set()
    for seed in range(24):
        rng = random.Random(seed)
        for ti in range(12):
            port_fuzz.rand_rules(rng, ti, tags)
        if port_fuzz.ALL_TAGS <= tags:
            break
    assert not port_fuzz.ALL_TAGS - tags, sorted(port_fuzz.ALL_TAGS - tags)


# -- the CI tier on the CPU --------------------------------------------
@pytest.mark.parametrize("seed", [11, 222, 3333])
def test_kernel_differential_fuzz_on_cpu(seed, native_on):
    rng = random.Random(seed)
    tags = set()
    checked = 0
    divergences = []
    native0 = port_fuzz.STATS["native_docs"]
    for ti in range(TRIALS):
        c, div = port_fuzz.run_trial(rng, ti, tags, "cpu")
        checked += c
        divergences.extend(div)
    assert not divergences, f"seed={seed}:\n" + "\n---\n".join(map(str, divergences[:3]))
    assert checked > 100, f"fuzz exercised too little: {checked}"
    assert port_fuzz.STATS["native_docs"] > native0, "leg (c) never ran"


def test_corpus_seeded_trial_runs():
    rng = random.Random(7)
    corpus = sorted((REPO / "corpus" / "rules").glob("*.guard"))
    assert corpus
    checked, div = port_fuzz.run_corpus_trial(rng, corpus[0], "cpu")
    assert not div, [str(d) for d in div[:2]]
    assert checked > 0


def test_big_document_trial_runs_on_cpu():
    """Trial 16 of a big-documents run is one bucket-crossing document."""
    rng = random.Random(3)
    tags = set()
    big0 = port_fuzz.STATS["big"]
    for ti in range(17):
        c, div = port_fuzz.run_trial(rng, ti, tags, "cpu", big_docs=ti == 16)
        assert not div, [str(d) for d in div[:2]]
    assert port_fuzz.STATS["big"] == big0 + 1


# -- the port against the JAX package ----------------------------------
def _jax_case(text, docs_plain):
    from guard_tpu.core.parser import parse_rules_file
    from guard_tpu.core.values import from_plain
    from guard_tpu.ops.encoder import encode_batch
    from guard_tpu.ops.fnvars import precompute_fn_values
    from guard_tpu.ops.ir import compile_rules_file
    from guard_tpu.ops.kernels import BatchEvaluator

    rf = parse_rules_file(text, "fuzz.guard")
    docs = [from_plain(d) for d in docs_plain]
    fn_vars, fn_vals, fn_err = precompute_fn_values(rf, docs)
    batch, interner = encode_batch(docs, fn_values=fn_vals, fn_var_order=fn_vars)
    compiled = compile_rules_file(rf, interner)
    if not compiled.rules:
        return None
    ev = BatchEvaluator(compiled)
    statuses = np.asarray(ev(batch))
    unsure = None if ev.last_unsure is None else np.asarray(ev.last_unsure)
    oracle = [jax_fuzz.oracle_statuses(rf, d) for d in docs]
    return [r.name for r in compiled.rules], statuses, unsure, fn_err, oracle


def _port_case(text, docs_plain):
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_batch
    from guard_tpu_torch.ops.fnvars import precompute_fn_values
    from guard_tpu_torch.ops.ir import compile_rules_file

    rf = t_parse(text, "fuzz.guard")
    docs = [from_plain(d) for d in docs_plain]
    fn_vars, fn_vals, fn_err = precompute_fn_values(rf, docs)
    batch, interner = encode_batch(docs, fn_values=fn_vals, fn_var_order=fn_vars)
    compiled = compile_rules_file(rf, interner)
    if not compiled.rules:
        return None
    run = port_fuzz.run_program(port_fuzz.make_evaluator(compiled, "cpu"), batch)
    oracle = [port_fuzz.oracle_statuses(rf, d) for d in docs]
    return [r.name for r in compiled.rules], run.statuses, run.unsure, fn_err, oracle


@pytest.mark.parametrize("seed", [1, 2])
def test_port_matches_the_jax_package(seed):
    from guard_tpu.core.errors import GuardError as JaxGuardError
    from guard_tpu.core.parser import parse_rules_file as j_parse
    from guard_tpu_torch.core.errors import GuardError

    rng = random.Random(seed)
    tags = set()
    compared = 0
    for ti in range(8):
        text = port_fuzz.rand_rules(rng, ti, tags)
        try:
            t_parse(text, "fuzz.guard")
        except GuardError:
            with pytest.raises(JaxGuardError):
                j_parse(text, "fuzz.guard")
            continue
        docs = [port_fuzz.rand_doc(rng) for _ in range(6)]
        port, jax = _port_case(text, docs), _jax_case(text, docs)
        assert (port is None) == (jax is None)
        if port is None:
            continue
        (p_names, p_st, p_un, p_err, p_oracle) = port
        (j_names, j_st, j_un, j_err, j_oracle) = jax
        assert p_names == j_names and p_err == j_err
        assert p_oracle == j_oracle, f"trial {ti}: the two CPU oracles differ"
        sure = np.ones(p_st.shape, bool)
        for un in (p_un, j_un):
            if un is not None:
                sure &= ~un
        sure[sorted(p_err)] = False
        np.testing.assert_array_equal(p_st[sure], j_st[sure])
        compared += int(sure.sum())
    assert compared > 20, compared


# -- an injected fault is caught ---------------------------------------
def _flipping(monkeypatch):
    """make_evaluator whose evaluators return the dispatch's statuses
    with the first cell moved to the next status."""
    real = port_fuzz.make_evaluator

    def make(compiled, device, fn=None):
        ev = real(compiled, device, fn)
        collect = ev.collect

        def flipped(handle):
            st, un, rim = collect(handle)
            st = st.copy()
            st[0, 0] = (st[0, 0] + 1) % 3
            return st, un, rim

        ev.collect = flipped
        return ev

    monkeypatch.setattr(port_fuzz, "make_evaluator", make)


def test_flipped_status_is_a_divergence(monkeypatch):
    _flipping(monkeypatch)
    rng = random.Random(1)
    tags = set()
    found = []
    for ti in range(10):
        found.extend(port_fuzz.run_trial(rng, ti, tags, "cpu")[1])
    assert found
    assert any("device=" in d.message and "oracle=" in d.message for d in found)
    assert any("with_summary's statuses" in d.message for d in found)


def test_main_writes_a_reproducer_on_divergence(monkeypatch, tmp_path, capsys, native_on):
    _flipping(monkeypatch)
    crash = tmp_path / "crash"
    rc = port_fuzz.main(["--device", "cpu", "--time", "30", "--seed", "1",
                         "--crash-dir", str(crash)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "DIVERGENCES:" in out
    repro = sorted(crash.iterdir())
    assert repro
    first = repro[0]
    text = (first / "rules.guard").read_text()
    docs = json.loads((first / "documents.json").read_text())
    assert (first / "divergence.txt").read_text().strip()
    # the reproducer replays: it diverges with the fault, not without it
    rf = t_parse(text, "fuzz.guard")
    assert port_fuzz.check_case(rf, text, docs, "cpu", "replay")[1]
    monkeypatch.setattr(port_fuzz, "make_evaluator", real_make_evaluator)
    assert not port_fuzz.check_case(rf, text, docs, "cpu", "replay")[1]


# -- the entry point ----------------------------------------------------
_MAIN = (
    "import sys\n"
    "from guard_tpu_torch.tools.kernel_fuzz import main\n"
    "rc = main(sys.argv[1:])\n"
    "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu'))\n"
    "print('LEAKED', leaked)\n"
    "sys.exit(rc)\n"
)


def test_main_on_cpu_in_a_subprocess(tmp_path, native_dir):
    env = dict(os.environ, GUARD_TPU_TORCH_NATIVE_DIR=str(native_dir))
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN, "--device", "cpu", "--time", "5", "--seed", "1",
         "--crash-dir", str(tmp_path / "crash")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    m = re.search(r"trials=(\d+) checked=(\d+) tags=(\d+)/(\d+) missing=\[", proc.stdout)
    assert m, proc.stdout
    assert int(m.group(1)) > 0 and int(m.group(2)) > 0
    assert int(m.group(4)) == len(jax_fuzz.ALL_TAGS)
    assert "no divergences" in proc.stdout
    assert "LEAKED []" in proc.stdout
    legs = json.loads(re.search(r"legs=(\{.*\})", proc.stdout).group(1))
    assert legs["native_docs"] > 0
    assert not (tmp_path / "crash").exists()


def test_no_card_and_no_device_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "guard_tpu_torch.tools.kernel_fuzz", "--time", "1"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2
    assert "--device cpu" in proc.stderr
    assert "trials=" not in proc.stdout
