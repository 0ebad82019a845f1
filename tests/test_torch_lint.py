"""`lint` in the port (guard_tpu_torch/analysis/lint.py and
commands/lint.py) against the JAX package's, on the CPU.

The port's linter is a copy over the port's own parser and values. The
same rule files give the same findings, and the port's CLI the same
stdout, stderr and exit code (0 clean / 19 findings at --fail-on / 5 a
parse error) as `python -m guard_tpu.cli lint`, in text and `-z` JSON
at every --fail-on level, with no tolerance: over the hand-built
fixture of each check (tests/test_lint.py), over corpus/rules and over
examples/rules.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.analysis import lint as jax_lint
from guard_tpu.core.parser import parse_rules_file as jax_parse
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.analysis import ANALYSIS_COUNTERS
from guard_tpu_torch.analysis import lint as port_lint
from guard_tpu_torch.commands.lint import lint_findings
from guard_tpu_torch.core.parser import parse_rules_file as port_parse
from guard_tpu_torch.utils.io import Reader, Writer
from test_lint import EXPECT, FIXTURES

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPORA = {"corpus": ROOT / "corpus" / "rules", "examples": ROOT / "examples" / "rules"}
FAIL_ON = ["error", "warning", "info", "never"]
MODES = {"text": [], "structured": ["-z"]}


def run_jax(args):
    w = JaxWriter.buffered()
    rc = jax_cli.run(["lint", *args], writer=w, reader=JaxReader())
    return rc, w.out.getvalue(), w.err.getvalue()


def run_port(args):
    w = Writer.buffered()
    rc = port_cli.run(["lint", *args], writer=w, reader=Reader())
    return rc, w.out.getvalue(), w.err.getvalue()


def write_fixtures(root, names):
    root.mkdir(exist_ok=True)
    for n in names:
        (root / n).write_text(FIXTURES[n])
    return root


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fail_on", FAIL_ON)
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_corpora_same_bytes_as_jax(corpus, fail_on, mode):
    args = ["-r", str(CORPORA[corpus]), "--fail-on", fail_on, *MODES[mode]]
    want = run_jax(args)
    got = run_port(args)
    assert got == want
    # the corpora hold INFO findings (cross-file duplicates) and nothing louder
    assert got[0] == (19 if fail_on == "info" and corpus == "corpus" else 0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fail_on", FAIL_ON)
def test_every_fixture_same_bytes_as_jax(tmp_path, fail_on, mode):
    root = write_fixtures(tmp_path / "rules", FIXTURES)
    args = ["-r", str(root), "--fail-on", fail_on, *MODES[mode]]
    want = run_jax(args)
    got = run_port(args)
    assert got == want
    assert got[0] == (0 if fail_on == "never" else 19)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_each_fixture_same_findings(name):
    """The library face: one file's findings, field for field."""
    want = [f.to_json() for f in jax_lint.lint_files([(name, jax_parse(FIXTURES[name], name))])]
    got = [f.to_json() for f in port_lint.lint_files([(name, port_parse(FIXTURES[name], name))])]
    assert got == want
    if name in EXPECT:
        assert EXPECT[name][0] in {f["code"] for f in got}
    else:
        assert got == []


def test_catalogue_and_severities_are_the_jax_ones():
    assert port_lint.CHECKS == jax_lint.CHECKS
    assert port_lint.SEVERITIES == jax_lint.SEVERITIES
    parsed = [(n, port_parse(c, n)) for n, c in FIXTURES.items()]
    assert port_lint.max_severity([]) is None
    assert port_lint.max_severity(port_lint.lint_files(parsed)) == "ERROR"


@pytest.mark.parametrize("mode", list(MODES))
def test_parse_error_takes_precedence_like_jax(tmp_path, mode):
    root = write_fixtures(tmp_path / "rules", ["unsat.guard", "shadow.guard"])
    (root / "broken.guard").write_text("rule broken {\n  this is not(((\n")
    args = ["-r", str(root), *MODES[mode]]
    want = run_jax(args)
    got = run_port(args)
    assert got == want
    assert got[0] == 5 and "Parse Error" in got[2]


def test_no_rules_is_the_jax_error(tmp_path):
    assert run_port([]) == run_jax([])
    assert run_port([])[0] == 5


def test_clean_fixture_and_empty_file(tmp_path):
    root = write_fixtures(tmp_path / "rules", ["ok.guard"])
    (root / "empty.guard").write_text("")
    args = ["-r", str(root)]
    got = run_port(args)
    assert got == run_jax(args)
    assert got[0] == 0 and got[1] == ""


def test_structured_summary_counts(tmp_path):
    root = write_fixtures(tmp_path / "rules", ["unsat.guard", "shadow.guard"])
    rc, out, _err = run_port(["-r", str(root), "-z", "--fail-on", "never"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["summary"]["files"] == 2 and doc["summary"]["error"] == 1


def test_lint_findings_counter_and_corpora_are_clean():
    before = ANALYSIS_COUNTERS["lint_findings"]
    findings = lint_findings([str(p) for p in CORPORA.values()])
    assert findings and all(f.code == "cross-file-duplicate" for f in findings)
    assert ANALYSIS_COUNTERS["lint_findings"] - before == len(findings)


def test_lint_process_imports_no_jax():
    code = (
        "import sys\n"
        "from guard_tpu_torch.cli import run\n"
        f"rc = run(['lint', '-r', {str(CORPORA['corpus'])!r}, '-z'])\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "sys.exit(rc)\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout)["summary"]["files"] == 249
