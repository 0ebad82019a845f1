"""The port's CLI against the JAX package's, and the port's boundaries.

`python -m guard_tpu_torch validate --statuses-only --device cpu` must
print the same stdout bytes and exit with the same code as
`python -m guard_tpu.cli validate --backend tpu --statuses-only`,
also on inputs the device cannot decide, which both rerun on their CPU
oracle: function variables, host rules, unsure bits, exotic numbers
and functions that raise. The port imports neither JAX nor guard_tpu,
and without a CUDA device it refuses to run unless asked for the CPU.

The JAX package puts an optional native statuses engine (native/,
built on demand) in front of its CPU evaluator where that engine
accepts the rules; a failing document it settles reports no clause
detail. The port's oracle is the CPU evaluator, so where an input
reaches the oracle the JAX side runs with the native engine off.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import __graft_entry__ as graft
from guard_tpu import cli as jax_cli
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.utils.io import Writer

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def corpus_dir(tmp_path):
    """Security policy + templates that PASS and FAIL, a document of no
    CloudFormation shape and a YAML one."""
    (tmp_path / "rules").mkdir()
    (tmp_path / "rules" / "security.guard").write_text(bench.RULES)
    (tmp_path / "rules" / "flagship.guard").write_text(graft._RULES)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(9)
    for i in range(12):
        (data / f"t{i:02d}.json").write_text(json.dumps(bench.make_template(rng, i)))
    (data / "plain.json").write_text(json.dumps({"a": 1, "b": [1, 2]}))
    (data / "tf.json").write_text(json.dumps({"resource_changes": []}))
    (data / "doc.yaml").write_text(
        "Resources:\n  b:\n    Type: AWS::S3::Bucket\n    Properties:\n"
        "      BucketName: UPPER\n"
    )
    return tmp_path


def run_jax(args):
    w = JaxWriter.buffered()
    rc = jax_cli.run(["validate", "--backend", "tpu", "--statuses-only", *args], writer=w)
    return rc, w.stripped()


def run_port(args):
    w = Writer.buffered()
    rc = port_cli.run(["validate", "--no-result-cache", "--statuses-only", "--device", "cpu",
                       *args], writer=w)
    return rc, w.stripped(), w.err_to_stripped()


@pytest.mark.parametrize("show", [None, "all", "pass,skip", "fail,pass"])
def test_stdout_and_rc_match_jax_cli(corpus_dir, show):
    args = ["-r", str(corpus_dir / "rules"), "-d", str(corpus_dir / "data")]
    if show:
        args += ["--show-summary", show]
    rc_j, out_j = run_jax(args)
    rc_p, out_p, err_p = run_port(args)
    assert rc_p == rc_j == 19, err_p
    assert out_p == out_j
    assert ("FAILED rules" in out_p) == (show is None or "fail" in show or show == "all")


def test_passing_corpus_exits_0(tmp_path):
    (tmp_path / "r.guard").write_text("rule has_a { a exists }\n")
    (tmp_path / "ok.json").write_text('{"a": 1}')
    args = ["-r", str(tmp_path / "r.guard"), "-d", str(tmp_path / "ok.json"),
            "--show-summary", "all"]
    rc_j, out_j = run_jax(args)
    rc_p, out_p, _ = run_port(args)
    assert rc_p == rc_j == 0 and out_p == out_j


def test_module_entry_point_matches(corpus_dir):
    args = ["-r", str(corpus_dir / "rules" / "flagship.guard"),
            "-d", str(corpus_dir / "data")]
    proc = subprocess.run(
        [sys.executable, "-m", "guard_tpu_torch", "validate", "--no-result-cache",
         "--statuses-only",
         "--device", "cpu", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    rc_j, out_j = run_jax(args)
    assert proc.returncode == rc_j
    assert proc.stdout == out_j


@pytest.fixture
def python_oracle(monkeypatch):
    """The JAX package with its CPU evaluator as the only oracle, and its
    serial encode (which its own tests hold byte-identical to the
    parallel one) in place of spawned ingest workers."""
    from guard_tpu.ops import native_oracle

    monkeypatch.setattr(native_oracle, "_load", lambda: None)
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")


def run_jax_err(args):
    w = JaxWriter.buffered()
    rc = jax_cli.run(["validate", "--backend", "tpu", "--statuses-only", *args], writer=w)
    return rc, w.stripped(), w.err_to_stripped()


def run_port_evaluation(args):
    """The port's CLI result and the Evaluation it reported from."""
    from guard_tpu_torch.commands import validate as port_validate

    seen = []
    real = port_validate.Validate.execute

    def execute(self, writer, reader):
        try:
            return real(self, writer, reader)
        finally:
            seen.append(self.last_evaluation)

    port_validate.Validate.execute = execute
    try:
        got = run_port(args)
    finally:
        port_validate.Validate.execute = real
    return got, seen[0]


@pytest.mark.parametrize("rules,doc_name,doc,why", [
    (graft._DRYRUN_RULES, "d.json", '{"Resources": {}}', "do not lower"),
    ("rule s { Resources.*.Properties.Size empty }", "d.json",
     '{"Resources": {"a": {"Properties": {"Size": 3}}}}', "cannot decide"),
    ("rule s { Resources exists }", "d.json",
     '{"Resources": {"a": 99999999999999999999999}}', "no exact device encoding"),
    ("rule r { Resources.a.b == Resources.c.d }", "d.json", '{"Resources": {}}',
     "pairwise"),
])
def test_host_oracle_inputs_exit_5(python_oracle, tmp_path, rules, doc_name, doc, why):
    """The inputs the JAX package sends to its oracle (host rules, an
    unsure bit, an exotic number) rerun on the port's CPU oracle instead
    of exiting 5: same stdout, stderr and exit code as the JAX package,
    one rerun each. Query-RHS compares run on the device."""
    (tmp_path / "r.guard").write_text(rules)
    (tmp_path / doc_name).write_text(doc)
    args = ["-r", str(tmp_path / "r.guard"), "-d", str(tmp_path / doc_name)]
    (rc, out, err), ev = run_port_evaluation(args)
    assert (rc, out, err) == run_jax_err(args)
    # `empty` on a number is unsure on the device and an error on the
    # oracle, which both packages report with exit code 5
    assert (rc == 5) == (why == "cannot decide") == (err != "")
    assert ev.oracle_docs == (0 if why == "pairwise" else 1)


@pytest.mark.parametrize("rules,doc", [
    # a list IN a list whose first element is not a list: subset mode,
    # decided per pair by the oracle
    ("rule r { Resources.* { Tags in Alias } }",
     {"Resources": {"a": {"Tags": ["x", "y"], "Alias": ["y", "x", "z"]}}}),
    # a number among the interpolated keys
    ("let names = Selection.targets\nrule r { Resources.%names exists }",
     {"Resources": {"a": {}}, "Selection": {"targets": ["a", 3]}}),
])
def test_unsure_query_rhs_inputs_exit_5(python_oracle, tmp_path, rules, doc):
    """A document with an unsure bit reruns on the oracle, whose answer
    stands: same bytes and exit code as the JAX package."""
    (tmp_path / "r.guard").write_text(rules)
    (tmp_path / "d.json").write_text(json.dumps(doc))
    args = ["-r", str(tmp_path / "r.guard"), "-d", str(tmp_path / "d.json"),
            "--show-summary", "all"]
    (rc, out, err), ev = run_port_evaluation(args)
    assert (rc, out, err) == run_jax_err(args)
    assert ev.oracle_docs == 1 and ev.files[0].unsure.any()


def test_function_variables_still_refused(python_oracle, tmp_path):
    """Function variables are no longer refused: canonical_names.guard
    lowers with no host rule, its walk selects the function results,
    and the output equals the JAX package's."""
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_batch
    from guard_tpu_torch.ops.fnvars import precompute_fn_values
    from guard_tpu_torch.ops.ir import compile_rules_file
    from guard_tpu_torch.ops.kernels import build_doc_evaluator

    rules = ROOT / "examples" / "rules" / "naming" / "canonical_names.guard"
    doc = {"Resources": {"b": {"Type": "AWS::S3::Bucket",
                               "Properties": {"BucketName": "Logs", "Env": "prod"}}}}
    (tmp_path / "d.json").write_text(json.dumps(doc))
    args = ["-r", str(rules), "-d", str(tmp_path / "d.json"), "--show-summary", "all"]
    (rc, out, err), ev = run_port_evaluation(args)
    assert (rc, out, err) == run_jax_err(args)
    assert rc == 19 and ev.oracle_docs == 0
    rf = parse_rules_file(rules.read_text(), rules.name)
    keys, vals, err_docs = precompute_fn_values(rf, [from_plain(doc)])
    assert not err_docs
    _batch, interner = encode_batch([from_plain(doc)], fn_values=vals, fn_var_order=keys)
    compiled = compile_rules_file(rf, interner)
    assert compiled.fn_vars and not compiled.host_rules
    assert callable(build_doc_evaluator(compiled))


def _canonical_template(fail: bool) -> dict:
    name = "Logs-Prod" if fail else "logs-prod"
    return {"Resources": {
        "b": {"Type": "AWS::S3::Bucket", "Properties": {"BucketName": name}},
        "i": {"Type": "AWS::EC2::Instance",
              "Properties": {"VolumeSize": 50, "ClassQuota": "100"}},
        "t": {"Type": "AWS::SQS::Queue",
              "Properties": {"Env": "prod", "Tags": {"g1": {"Env": "prod"}}}},
    }}


CLI_CASES = {
    # canonical_names.guard over a PASS and a FAIL template
    "canonical_pass_fail": (
        (ROOT / "examples" / "rules" / "naming" / "canonical_names.guard").read_text(),
        {"pass.json": _canonical_template(False), "fail.json": _canonical_template(True)},
    ),
    # parse_int raises on this quota: the document goes to the oracle,
    # whose error goes to stderr and makes the exit code 5
    "function_error": (
        (ROOT / "examples" / "rules" / "naming" / "canonical_names.guard").read_text(),
        {"bad.json": {"Resources": {"i": {
            "Type": "AWS::EC2::Instance",
            "Properties": {"VolumeSize": 5, "ClassQuota": "abc"}}}},
         "ok.json": _canonical_template(False)},
    ),
    # a now() host rule: every document reruns on the oracle
    "now_host_rule": (
        "rule fresh { let t = now()\n %t > 0 }\n"
        "rule named when Resources exists { Resources.*.Properties.BucketName == /^[a-z-]+$/ }\n",
        {"pass.json": _canonical_template(False), "fail.json": _canonical_template(True)},
    ),
    # a number with no exact device encoding
    "exotic_number": (
        (ROOT / "examples" / "rules" / "naming" / "canonical_names.guard").read_text(),
        {"exotic.json": dict(_canonical_template(True), Metadata={"Build": 2**70}),
         "ok.json": _canonical_template(False)},
    ),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_module_cli_matches_jax_cli_on_oracle_inputs(tmp_path, case):
    """`python -m guard_tpu_torch` against `python -m guard_tpu.cli`, as
    processes: stdout bytes, stderr bytes and the exit code."""
    rules, docs = CLI_CASES[case]
    (tmp_path / "r.guard").write_text(rules)
    data = tmp_path / "data"
    data.mkdir()
    for name, doc in docs.items():
        (data / name).write_text(json.dumps(doc))
    (tmp_path / "no_native").mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", GUARD_TPU_INGEST_WORKERS="0",
               GUARD_TPU_NATIVE_DIR=str(tmp_path / "no_native"))
    args = ["validate", "--statuses-only", "-r", str(tmp_path / "r.guard"), "-d", str(data)]
    for show in ([], ["--show-summary", "all"]):
        jax_proc = subprocess.run(
            [sys.executable, "-m", "guard_tpu.cli", *args, "--backend", "tpu", *show],
            cwd=ROOT, capture_output=True, timeout=300, env=env,
        )
        port_proc = subprocess.run(
            [sys.executable, "-m", "guard_tpu_torch", *args, "--no-result-cache",
             "--device", "cpu", *show],
            cwd=ROOT, capture_output=True, timeout=300, env=env,
        )
        assert port_proc.returncode == jax_proc.returncode
        assert port_proc.stdout == jax_proc.stdout
        assert port_proc.stderr == jax_proc.stderr
    want_rc = {"canonical_pass_fail": 19, "function_error": 5, "now_host_rule": 19,
               "exotic_number": 19}[case]
    assert port_proc.returncode == want_rc


def test_missing_statuses_only_is_refused(tmp_path):
    """--statuses-only is a mode of its own: with a non-default output
    format it is refused (rc 5, the JAX package's message); without it
    the run reports each failing clause."""
    (tmp_path / "r.guard").write_text("rule a { a exists }\n")
    (tmp_path / "d.json").write_text('{"b": 1}')
    args = ["validate", "--no-result-cache", "--device", "cpu", "-r", str(tmp_path / "r.guard"),
            "-d", str(tmp_path / "d.json")]
    w = Writer.buffered()
    rc = port_cli.run([*args, "--statuses-only", "-o", "json"], writer=w)
    assert rc == 5 and "Error: statuses-only conflicts" in w.err_to_stripped()
    w = Writer.buffered()
    rc = port_cli.run(args, writer=w)
    assert rc == 19 and "property [a] is missing" in w.stripped()


def test_no_cuda_no_device_raises(monkeypatch, tmp_path):
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.parallel.device import resolve_device
    from guard_tpu_torch.utils.io import Reader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "r.guard").write_text("rule a { a exists }\n")
    (tmp_path / "d.json").write_text('{"a": 1}')
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    cmd = Validate(rules=[str(tmp_path / "r.guard")], data=[str(tmp_path / "d.json")],
                   statuses_only=True, result_cache=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cmd.execute(Writer.buffered(), Reader.from_string(""))
    w = Writer.buffered()
    rc = port_cli.run(["validate", "--no-result-cache", "--statuses-only",
                       "-r", str(tmp_path / "r.guard"),
                       "-d", str(tmp_path / "d.json")], writer=w)
    assert rc == 5 and w.stripped() == "" and "CUDA" in w.err_to_stripped()


_ISOLATION = r"""
import sys
from guard_tpu_torch.cli import run
from guard_tpu_torch.utils.io import Writer
w = Writer.buffered()
rc = run(sys.argv[1:], writer=w)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "guard_tpu"))
print(rc, bad)
"""


def test_port_process_imports_no_jax_and_no_guard_tpu(corpus_dir):
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATION, "validate", "--no-result-cache", "--statuses-only",
         "--device", "cpu", "-r", str(corpus_dir / "rules"), "-d",
         str(corpus_dir / "data")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["19", "[]"]


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|guard_tpu)(?:[.\s,]|$)", re.M)


def test_static_scan_finds_no_jax_or_guard_tpu_import():
    files = sorted((ROOT / "guard_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files for m in _IMPORT.finditer(f.read_text())
    ]
    assert hits == []


QUERY_RHS_CORPUS = [
    "query_vs_query_053", "var_query_rhs_047", "var_query_rhs_v1_111",
    "var_query_rhs_v2_172", "var_query_rhs_v3_234", "var_interpolation_048",
    "var_interpolation_v2_173",
]


def _corpus_inputs(stem: str):
    import yaml

    spec = ROOT / "corpus" / "rules" / "tests" / f"{stem}_tests.yaml"
    return [c["input"] for c in yaml.safe_load(spec.read_text()) or []
            if isinstance(c, dict) and "input" in c]


@pytest.mark.parametrize("stem", QUERY_RHS_CORPUS)
def test_query_rhs_corpus_cli_matches_jax(tmp_path, stem):
    data = tmp_path / "data"
    data.mkdir()
    for i, doc in enumerate(_corpus_inputs(stem)):
        (data / f"case{i:02d}.json").write_text(json.dumps(doc))
    args = ["-r", str(ROOT / "corpus" / "rules" / f"{stem}.guard"), "-d", str(data),
            "--show-summary", "all"]
    rc_j, out_j = run_jax(args)
    rc_p, out_p, err_p = run_port(args)
    assert rc_p == rc_j and rc_p in (0, 19), err_p
    assert out_p == out_j


def test_xref_rules_cli_matches_jax(tmp_path):
    from guard_tpu_torch.workloads import XREF_RULES, make_xref_template

    (tmp_path / "xref.guard").write_text(XREF_RULES)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(17)
    for i in range(24):
        (data / f"t{i:02d}.json").write_text(json.dumps(make_xref_template(rng, i)))
    for show in (None, "all"):
        args = ["-r", str(tmp_path / "xref.guard"), "-d", str(data)]
        if show:
            args += ["--show-summary", show]
        rc_j, out_j = run_jax(args)
        rc_p, out_p, err_p = run_port(args)
        assert rc_p == rc_j == 19, err_p
        assert out_p == out_j
