"""Full validate reports of the port against the JAX package's.

`python -m guard_tpu_torch validate --device cpu` must print the same
stdout and stderr bytes and exit with the same code as `python -m
guard_tpu.cli validate --backend tpu` with the same flags, in every
output format and with every validate flag, in both states of the
native oracle: not built (both packages rerun on their CPU evaluator)
and built (both load one library, compiled once per test run from
native/oracle.cpp into a temporary directory). The JAX side runs with
its result cache off, so that its output is computed, not replayed.

Also here: the reporters against the JAX package's functions on the
same report dicts, the spawn pool of oracle reruns, the shared encode
that only runs when a file uses it, and the port's boundaries (no JAX,
no guard_tpu, no torch in a pool worker, nothing written under
native/).
"""

import copy
import json
import os
import pathlib
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import yaml

import bench
import __graft_entry__ as graft
from guard_tpu import cli as jax_cli
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.commands import validate as port_validate
from guard_tpu_torch.utils.io import Reader, Writer

ROOT = pathlib.Path(__file__).resolve().parent.parent
NATIVE = ROOT / "native"


# -- both packages' native oracle state -------------------------------
@pytest.fixture(scope="session")
def native_lib_dir(tmp_path_factory):
    """The native oracle, built once per test run by the port's
    build_native() into a temporary directory."""
    from guard_tpu_torch.ops import _native_lib, native_oracle

    d = tmp_path_factory.mktemp("native_oracle")
    saved = _native_lib.NATIVE_DIR
    _native_lib.NATIVE_DIR = d
    try:
        path = native_oracle.build_native()
    finally:
        _native_lib.NATIVE_DIR = saved
    assert path == d / "libguard_oracle.so" and path.exists()
    return d


def set_native(monkeypatch, lib_dir) -> None:
    """Put both packages' native oracle in one state: not built (None),
    or built in `lib_dir`."""
    from guard_tpu.ops import _native_lib as jax_lib
    from guard_tpu.ops import native_oracle as jax_oracle
    from guard_tpu_torch.ops import _native_lib as port_lib
    from guard_tpu_torch.ops import native_oracle as port_oracle

    for lib, oracle in ((jax_lib, jax_oracle), (port_lib, port_oracle)):
        if lib_dir is None:
            monkeypatch.setattr(oracle, "_load", lambda: None)
        else:
            monkeypatch.setattr(lib, "NATIVE_DIR", pathlib.Path(lib_dir))
            monkeypatch.setattr(lib, "_libs", {})
            monkeypatch.setattr(oracle, "_configured", None)


@pytest.fixture(autouse=True)
def _computed_not_replayed(monkeypatch):
    """The JAX package with its result cache off and its serial encode
    (its own tests hold that byte-identical to the parallel one)."""
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")


@pytest.fixture(params=["native_off", "native_built"])
def native_state(request, monkeypatch):
    lib_dir = None
    if request.param == "native_built":
        lib_dir = request.getfixturevalue("native_lib_dir")
    set_native(monkeypatch, lib_dir)
    return request.param


# -- running both CLIs ------------------------------------------------
class _Recording(port_validate.Validate):
    """The port's Validate, remembering the last instance run."""

    last = None

    def execute(self, writer, reader):
        _Recording.last = self
        return super().execute(writer, reader)


def run_jax(args, stdin=None):
    w = JaxWriter.buffered()
    r = JaxReader.from_string(stdin) if stdin is not None else None
    rc = jax_cli.run(["validate", "--backend", "tpu", *args], writer=w, reader=r)
    return rc, w.stripped(), w.err_to_stripped()


def run_port(args, stdin=None):
    """(rc, stdout, stderr) of the port's CLI on the CPU, and the
    Evaluation it reported from (None when it stopped before one)."""
    w = Writer.buffered()
    r = Reader.from_string(stdin) if stdin is not None else None
    _Recording.last = None
    with mock.patch.object(port_cli, "Validate", _Recording):
        rc = port_cli.run(["validate", "--no-result-cache", "--device", "cpu", *args],
                          writer=w, reader=r)
    ev = _Recording.last.last_evaluation if _Recording.last is not None else None
    return (rc, w.stripped(), w.err_to_stripped()), ev


def assert_same(args, stdin=None):
    """Both CLIs give the same rc, stdout and stderr; the port's
    Evaluation."""
    want = run_jax(args, stdin)
    got, ev = run_port(args, stdin)
    assert got[0] == want[0], (got[2], want[2])
    assert got[2] == want[2]
    assert got[1] == want[1]
    return got, ev


# -- the 15-document fixture ------------------------------------------
def write_fixture(root: pathlib.Path) -> pathlib.Path:
    """Security policy + templates that PASS and FAIL, a document of no
    CloudFormation shape, a Terraform plan and a YAML template."""
    (root / "rules").mkdir()
    (root / "rules" / "security.guard").write_text(bench.RULES)
    (root / "rules" / "flagship.guard").write_text(graft._RULES)
    data = root / "data"
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
    return root


@pytest.fixture
def fixture_dir(tmp_path):
    return write_fixture(tmp_path)


def fixture_args(root):
    return ["-r", str(root / "rules"), "-d", str(root / "data")]


CLI_FLAGS = {
    "show_fail": [],
    "show_all": ["-S", "all"],
    "show_pass_skip": ["-S", "pass,skip"],
    "json": ["-o", "json"],
    "yaml": ["-o", "yaml"],
    "json_show_all": ["-o", "json", "-S", "all"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
    "structured_yaml": ["-z", "-o", "yaml", "-S", "none"],
    "structured_sarif": ["-z", "-o", "sarif", "-S", "none"],
    "structured_junit": ["-z", "-o", "junit", "-S", "none"],
    "verbose": ["-v"],
    "print_json": ["-p"],
    "verbose_structured_json": ["-v", "-z", "-o", "json", "-S", "none"],
    "alphabetical": ["-a"],
    "last_modified": ["-m"],
    "type": ["-t", "CFN"],
    "statuses_only": ["--statuses-only", "-S", "all"],
}


@pytest.mark.parametrize("case", sorted(CLI_FLAGS))
def test_cli_flags_match_jax(native_state, fixture_dir, case):
    (rc, out, _err), ev = assert_same([*fixture_args(fixture_dir), *CLI_FLAGS[case]])
    assert rc == 19 and out
    counts = ev.reruns
    rich_tree = case in ("verbose", "print_json", "verbose_structured_json")
    if case == "statuses_only" or native_state == "native_off" or rich_tree:
        # no native oracle: every rerun on the CPU evaluator
        assert counts["native_reports"] == counts["native_statuses"] == 0
    if case != "statuses_only":
        # a full report reruns every failing document
        fails = sum(int(fr.rim[3][:, 0].sum()) for fr in ev.files)
        assert counts["native_reports"] + ev.oracle_docs >= fails > 0
        if native_state == "native_built" and not rich_tree:
            assert counts["native_reports"] >= fails


def test_input_params_match_jax(native_state, fixture_dir):
    """-i merges a parameters document into every data document; a rule
    reads it. The merged trees keep the reruns in this process."""
    (fixture_dir / "rules" / "params.guard").write_text(
        "let allowed = Params.sizes\n"
        "rule sizes_allowed when Resources exists {\n"
        "  Resources.*[ Type == 'AWS::EC2::Volume' ].Properties.Size IN %allowed\n"
        "}\n"
    )
    (fixture_dir / "params.yaml").write_text("Params:\n  sizes: [8, 16, 64]\n")
    for extra in ([], ["-S", "all"], ["-z", "-o", "json", "-S", "none"]):
        (rc, _out, _err), ev = assert_same(
            [*fixture_args(fixture_dir), "-i", str(fixture_dir / "params.yaml"), *extra]
        )
        assert rc == 19 and ev.reruns["pooled"] == 0


def test_payload_on_stdin_matches_jax(native_state):
    """-P reads `{"rules": [...], "data": [...]}` from stdin; data given
    as objects and as strings, a rule file that does not parse."""
    rng = np.random.default_rng(4)
    docs = [bench.make_template(rng, i) for i in range(6)]
    payload = json.dumps({
        "rules": [bench.RULES, graft._RULES, "rule broken {"],
        "data": [docs[0], json.dumps(docs[1]), *docs[2:]],
    })
    for extra in ([], ["-S", "all"], ["-z", "-o", "junit", "-S", "none"]):
        (rc, _out, err), _ev = assert_same(["-P", *extra], stdin=payload)
        assert rc == 19 and "Parse Error on ruleset file RULES_STDIN[3]" in err
    (rc, _out, err), _ev = assert_same(["-P"], stdin="not json")
    assert rc == 5 and err.startswith("Error: ")


CONFLICTS = {
    "structured_with_summary": ["-z", "-o", "json"],
    "structured_single_line": ["-z", "-S", "none"],
    "junit_unstructured": ["-o", "junit"],
    "sarif_unstructured": ["-o", "sarif"],
    "payload_with_rules": ["-P"],
    "no_rules": None,
    "alphabetical_last_modified": ["-a", "-m"],
    "statuses_only_structured": ["--statuses-only", "-z", "-o", "json", "-S", "none"],
    "statuses_only_verbose": ["--statuses-only", "-v"],
    "statuses_only_print_json": ["--statuses-only", "-p"],
    "statuses_only_yaml": ["--statuses-only", "-o", "yaml"],
}


@pytest.mark.parametrize("case", sorted(CONFLICTS))
def test_argument_conflicts_match_jax(native_state, fixture_dir, case):
    extra = CONFLICTS[case]
    args = ["-d", str(fixture_dir / "data")] if extra is None else [
        *fixture_args(fixture_dir), *extra
    ]
    (rc, out, err), ev = assert_same(args)
    assert rc == 5 and out == "" and err.startswith("Error: ") and ev is None


def test_missing_paths_match_jax(native_state, fixture_dir):
    for args in (
        ["-r", str(fixture_dir / "nope.guard"), "-d", str(fixture_dir / "data")],
        [*fixture_args(fixture_dir), "-i", str(fixture_dir / "nope.yaml")],
    ):
        (rc, out, err), _ev = assert_same(args)
        assert rc == 5 and out == "" and "does not exist" in err


def test_document_that_does_not_parse_matches_jax(native_state, fixture_dir):
    (fixture_dir / "data" / "zz_bad.json").write_text('{"Resources": [1, 2')
    for extra in ([], ["-z", "-o", "json", "-S", "none"]):
        (rc, out, err), _ev = assert_same([*fixture_args(fixture_dir), *extra])
        assert rc == 5 and out == "" and err


def _oracle_inputs():
    """The inputs the device does not decide alone: function variables
    (one raising), a now() host rule, an exotic number, an unsure bit,
    a rules file that does not lower."""
    from test_torch_cli import CLI_CASES

    cases = dict(CLI_CASES)
    cases["host_rules_only"] = (graft._DRYRUN_RULES, {"d.json": {"Resources": {}}})
    cases["unsure_empty_number"] = (
        "rule s { Resources.*.Properties.Size empty }",
        {"d.json": {"Resources": {"a": {"Properties": {"Size": 3}}}}},
    )
    cases["unsure_list_subset"] = (
        "rule r { Resources.* { Tags in Alias } }",
        {"d.json": {"Resources": {"a": {"Tags": ["x", "y"], "Alias": ["y", "x", "z"]}}}},
    )
    return cases


ORACLE_INPUTS = _oracle_inputs()


@pytest.mark.parametrize("case", sorted(ORACLE_INPUTS))
def test_oracle_inputs_match_jax(native_state, tmp_path, case):
    """Documents the device leaves to the oracle, in full reports: the
    same bytes and exit code (5 where a function raises or `empty`
    meets a number) in both native states."""
    rules, docs = ORACLE_INPUTS[case]
    (tmp_path / "r.guard").write_text(rules)
    data = tmp_path / "data"
    data.mkdir()
    for name, doc in docs.items():
        (data / name).write_text(json.dumps(doc))
    for extra in ([], ["-S", "all"], ["-z", "-o", "json", "-S", "none"],
                  ["-z", "-o", "junit", "-S", "none"]):
        (rc, _out, err), _ev = assert_same(
            ["-r", str(tmp_path / "r.guard"), "-d", str(data), *extra]
        )
        assert (rc == 5) == bool(err)
        assert rc == (5 if case in ("function_error", "unsure_empty_number") else
                      0 if case in ("host_rules_only", "unsure_list_subset") else 19)


# -- the reporters on the same report dicts ---------------------------
def _jax_reports(rules_text, docs):
    """Reports of the JAX package's CPU evaluator, and the port's on the
    same inputs (which must be equal)."""
    from guard_tpu.commands.report import simplified_report_from_root as j_report
    from guard_tpu.core.evaluator import eval_rules_file as j_eval
    from guard_tpu.core.parser import parse_rules_file as j_parse
    from guard_tpu.core.scopes import RootScope as JScope
    from guard_tpu.core.loader import load_document as j_load
    from guard_tpu_torch.commands.report import simplified_report_from_root as p_report
    from guard_tpu_torch.core.evaluator import eval_rules_file as p_eval
    from guard_tpu_torch.core.parser import parse_rules_file as p_parse
    from guard_tpu_torch.core.scopes import RootScope as PScope
    from guard_tpu_torch.core.loader import load_document as p_load

    jrf, prf = j_parse(rules_text, "r.guard"), p_parse(rules_text, "r.guard")
    out = []
    for i, doc in enumerate(docs):
        name, text = f"d{i:02d}.json", json.dumps(doc, indent=1)
        js = JScope(jrf, j_load(text, name))
        jst = j_eval(jrf, js, name)
        ps = PScope(prf, p_load(text, name))
        pst = p_eval(prf, ps, name)
        jr = j_report(js.reset_recorder().extract(), name)
        pr = p_report(ps.reset_recorder().extract(), name)
        assert jr == pr and jst.value == pst.value
        out.append((jr, jst.value))
        # a second rules file's report of the same document, for the
        # per-name merges of combine_reports
        if i % 3 == 0:
            out.append((dict(jr, not_applicable=["extra_rule"], compliant=[]), jst.value))
    return out


def _report_sets():
    from guard_tpu_torch.workloads import XREF_RULES, make_xref_template

    rng = np.random.default_rng(21)
    corpus = ROOT / "corpus" / "rules"
    sets = {
        "security": (bench.RULES, [bench.make_template(rng, i) for i in range(10)]),
        "xref": (XREF_RULES, [make_xref_template(rng, i) for i in range(10)]),
    }
    # a corpus file with custom messages
    for p in sorted(corpus.glob("*.guard")):
        text = p.read_text()
        if "<<" in text:
            spec = corpus / "tests" / f"{p.stem}_tests.yaml"
            docs = [c["input"] for c in yaml.safe_load(spec.read_text()) or []
                    if isinstance(c, dict) and "input" in c]
            if docs:
                sets["custom_messages"] = (text, docs)
                break
    return sets


REPORT_SETS = _report_sets()


def _reporter_output(pkg: str, fn: str, reports):
    """`fn` of package `pkg`'s reporters on (report, status) pairs; a
    string or a plain value to compare."""
    import importlib

    base = "guard_tpu" if pkg == "jax" else "guard_tpu_torch"
    structured = importlib.import_module(f"{base}.commands.reporters.structured")
    sarif = importlib.import_module(f"{base}.commands.reporters.sarif")
    junit = importlib.import_module(f"{base}.commands.reporters.junit")
    status = importlib.import_module(f"{base}.core.qresult").Status
    io_mod = importlib.import_module(f"{base}.utils.io")
    dicts = [copy.deepcopy(r) for r, _ in reports]
    w = io_mod.Writer.buffered()
    if fn == "combine_reports":
        return structured.combine_reports(dicts)
    if fn == "_strip_locations":
        return structured._strip_locations(dicts)
    if fn == "build_sarif":
        return sarif.build_sarif(dicts)
    if fn == "write_sarif":
        sarif.write_sarif(w, dicts)
    elif fn == "failure_info_from_report":
        return [junit.failure_info_from_report(r) for r in dicts]
    elif fn == "write_junit":
        suites = {}
        for r, st in zip(dicts, (s for _, s in reports)):
            name, msgs = junit.failure_info_from_report(r)
            failed = st == "FAIL"
            suites.setdefault(r["name"], []).append(junit.JunitTestCase(
                name="r.guard", status=status(st),
                failure_name=name if failed else None,
                failure_messages=msgs if failed else None,
                error='bad <"doc"> & more' if r["name"] == "d01.json" else None,
            ))
        junit.write_junit(w, suites)
    elif fn.startswith("write_structured_"):
        structured.write_structured(w, dicts, fn.rsplit("_", 1)[1])
    return w.stripped()


REPORTERS = (
    "combine_reports", "_strip_locations", "build_sarif", "write_sarif",
    "failure_info_from_report", "write_junit", "write_structured_json",
    "write_structured_yaml",
)


@pytest.mark.parametrize("reports", sorted(REPORT_SETS))
@pytest.mark.parametrize("fn", REPORTERS)
def test_reporter_matches_jax(fn, reports):
    pairs = _jax_reports(*REPORT_SETS[reports])
    assert any(st == "FAIL" for _, st in pairs)
    got = _reporter_output("port", fn, pairs)
    want = _reporter_output("jax", fn, pairs)
    assert got == want and got
    if fn == "write_sarif":
        assert json.loads(got)["runs"][0]["results"]
    if fn == "write_junit":
        import xml.etree.ElementTree as ET

        assert ET.fromstring(got.encode()).tag == "testsuites"


# -- the pool ----------------------------------------------------------
def _failing_corpus(root: pathlib.Path, n: int) -> list:
    """`n` templates that all FAIL the security policy."""
    from guard_tpu_torch.workloads import make_template

    rng = np.random.default_rng(33)
    data = root / "data"
    data.mkdir()
    (root / "security.guard").write_text(bench.RULES)
    kept = 0
    i = 0
    while kept < n:
        doc = make_template(rng, i)
        i += 1
        doc["Resources"]["zz_plain_volume"] = {
            "Type": "AWS::EC2::Volume", "Properties": {"Encrypted": False, "Size": 8},
        }
        (data / f"t{kept:03d}.json").write_text(json.dumps(doc))
        kept += 1
    return ["-r", str(root / "security.guard"), "-d", str(data)]


def test_pool_reruns_match_jax(monkeypatch, tmp_path):
    """60 failing documents, over the pool's threshold of 48, with the
    native oracle off: the reruns go through the spawn pool and the
    output is byte-equal to the JAX package's."""
    from guard_tpu_torch.ops.oracle_pool import POOL_MIN_JOBS

    set_native(monkeypatch, None)
    args = _failing_corpus(tmp_path, 60)
    for extra in ([], ["-z", "-o", "json", "-S", "none"]):
        (rc, out, _err), ev = assert_same([*args, *extra])
        assert rc == 19 and out
        counts = ev.reruns
        assert ev.files[0].rim[3][:, 0].all()
        assert counts["pooled"] == 60 > POOL_MIN_JOBS and counts["inline"] == 0
        assert counts["pool_failures"] == 0 and ev.oracle_docs == 60


def test_pool_that_cannot_start_falls_back_inline(monkeypatch, tmp_path):
    """A pool that fails to start leaves the reruns inline, with the
    same bytes, and is counted."""
    from guard_tpu_torch.ops import oracle_pool

    set_native(monkeypatch, None)
    args = _failing_corpus(tmp_path, 50)

    def broken(*_a, **_k):
        raise OSError("no processes here")

    monkeypatch.setattr(oracle_pool, "run_oracle_jobs", broken)
    (rc, _out, _err), ev = assert_same(args)
    assert rc == 19
    assert ev.reruns["pool_failures"] == 1 and ev.reruns["inline"] == 50
    assert ev.reruns["pooled"] == 0


# -- the shared encode --------------------------------------------------
def test_shared_encode_only_when_used(monkeypatch, tmp_path):
    """A run mixing a file with function variables and one without, and
    a run of the function-variable file alone: each file's statuses,
    unsure bits and rim blocks equal its own single-file evaluation,
    stdout equals the JAX package's, and the run without a file that
    uses the shared encode skips it."""
    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops import backend
    from guard_tpu_torch.workloads import FNVAR_RULES, make_fnvar_template

    set_native(monkeypatch, None)
    rng = np.random.default_rng(5)
    plain_docs = [make_fnvar_template(rng, i) for i in range(16)]
    data = tmp_path / "data"
    data.mkdir()
    for i, doc in enumerate(plain_docs):
        (data / f"t{i:02d}.json").write_text(json.dumps(doc))
    (tmp_path / "a_fnvar.guard").write_text(FNVAR_RULES)
    (tmp_path / "b_security.guard").write_text(bench.RULES)
    files = {
        name: RuleFile(name, name, (tmp_path / name).read_text(),
                       parse_rules_file((tmp_path / name).read_text(), name))
        for name in ("a_fnvar.guard", "b_security.guard")
    }
    docs = [from_plain(d) for d in plain_docs]
    alone = {name: backend.evaluate([rf], docs, "cpu").files[0] for name, rf in files.items()}
    for names in (("a_fnvar.guard", "b_security.guard"), ("a_fnvar.guard",)):
        ev = backend.evaluate([files[n] for n in names], docs, "cpu")
        assert (ev.groups is None) == (names == ("a_fnvar.guard",))
        for name, fr in zip(names, ev.files):
            ref = alone[name]
            assert (fr.statuses == ref.statuses).all() and (fr.unsure == ref.unsure).all()
            for a, b in zip(fr.rim, ref.rim):
                assert a.dtype == b.dtype and (a == b).all()
            assert fr.groups is not None
        rules = [str(tmp_path / n) for n in names]
        for extra in (["--statuses-only", "-S", "all"], ["-S", "all"]):
            (rc, out, _err), pev = assert_same(["-r", *rules, "-d", str(data), *extra])
            assert rc == 19 and out
            assert (pev.groups is None) == (names == ("a_fnvar.guard",))


# -- boundaries ----------------------------------------------------------
_ISOLATION = r"""
import multiprocessing as mp
import sys
from guard_tpu_torch.cli import run
from guard_tpu_torch.ops.oracle_pool import _oracle_pool_init, worker_modules
from guard_tpu_torch.utils.io import Writer

if __name__ == "__main__":
    w = Writer.buffered()
    rc = run(sys.argv[1:], writer=w)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "guard_tpu"))
    with mp.get_context("spawn").Pool(2, initializer=_oracle_pool_init,
                                      initargs=([],)) as pool:
        workers = pool.map(worker_modules, range(2))
    print(rc, bad, workers)
"""


def test_full_report_process_imports_no_jax(tmp_path):
    """A full-report run of the port in its own process, with the pool
    running its reruns: no JAX or guard_tpu module is imported, and a
    pool worker holds neither those nor torch."""
    args = _failing_corpus(tmp_path, 50)
    script = tmp_path / "isolation.py"
    script.write_text(_ISOLATION)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GUARD_TPU_TORCH_NATIVE_DIR"] = str(tmp_path / "not_built")
    proc = subprocess.run(
        [sys.executable, str(script), "validate", "--no-result-cache", "--device", "cpu",
         *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(env, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "19 [] [[], []]"


NEW_MODULES = (
    "guard_tpu_torch/core/ast_serde.py",
    "guard_tpu_torch/ops/_native_lib.py",
    "guard_tpu_torch/ops/native_oracle.py",
    "guard_tpu_torch/ops/oracle_pool.py",
    "guard_tpu_torch/ops/backend.py",
    "guard_tpu_torch/commands/validate.py",
    "guard_tpu_torch/commands/reporters/__init__.py",
    "guard_tpu_torch/commands/reporters/aware.py",
    "guard_tpu_torch/commands/reporters/console.py",
    "guard_tpu_torch/commands/reporters/structured.py",
    "guard_tpu_torch/commands/reporters/sarif.py",
    "guard_tpu_torch/commands/reporters/junit.py",
    "guard_tpu_torch/cli.py",
)
_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|guard_tpu)(?:[.\s,]|$)", re.M)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_no_jax(module):
    text = (ROOT / module).read_text()
    assert _IMPORT.findall(text) == []


def test_oracle_pool_imports_no_torch():
    """What a pool worker imports: the pool module and the pure-Python
    core, never torch."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; import guard_tpu_torch.ops.oracle_pool as p; "
         "print(p.worker_modules())"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_build_failure_raises_with_compiler_stderr(monkeypatch, tmp_path):
    from guard_tpu_torch.ops import _native_lib

    monkeypatch.setattr(_native_lib, "NATIVE_DIR", tmp_path / "lib")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build libbad.so"):
        _native_lib.build("libbad.so", bad)
    assert not list((tmp_path / "lib").iterdir())


def test_native_oracle_not_built_declines(monkeypatch, tmp_path):
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.ops import _native_lib, native_oracle

    monkeypatch.setattr(_native_lib, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_native_lib, "_libs", {})
    monkeypatch.setattr(native_oracle, "_configured", None)
    assert not native_oracle.native_available()
    with pytest.raises(native_oracle.NativeUnsupported):
        native_oracle.NativeOracle(parse_rules_file("rule a { a exists }\n", "r.guard"))


def _native_tree():
    return {
        p.name: (p.stat().st_mtime_ns, p.stat().st_size)
        for p in sorted(NATIVE.iterdir())
    }


NATIVE_AT_IMPORT = _native_tree()


def test_zz_nothing_written_under_native(native_lib_dir):
    """After this file's runs (and the library's build), native/ holds
    the same files with the same times and sizes as when it was
    collected."""
    assert native_lib_dir != NATIVE
    assert _native_tree() == NATIVE_AT_IMPORT
