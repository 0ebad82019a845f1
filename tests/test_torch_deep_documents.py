"""Deep documents and the port's package top, against the JAX package.

  * Documents nested 1,000 and 3,000 deep, as JSON and as YAML (block
    style), through the port's CLI in a process that never imports
    guard_tpu (`--backend cpu`, and the device path with `--device
    cpu`), give the rc and stdout bytes of the JAX CLI run in a process
    of its own (`--backend cpu` and `--backend tpu`). The port's
    process checks that its recursion limit is at least 20,000 and that
    no jax or guard_tpu module was imported. A parity test that imports
    both packages cannot see this: importing guard_tpu raises the limit
    for the whole process.
  * In a fresh process, `import guard_tpu_torch` raises the recursion
    limit to 20,000 and imports no torch, jax or guard_tpu.
  * `guard_tpu_torch.run_checks` returns `guard_tpu.run_checks`'s
    string on corpus (rules, input) pairs, plain and verbose, and the
    two packages' `__all__` name the same things.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import yaml

import guard_tpu
import guard_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus" / "rules"
# every 10th rules file in sorted order, with its first test input
CORPUS_SAMPLE = [p.name for p in sorted(CORPUS.glob("*.guard"))[::10]]

RULES = """
rule typed { Resources.*.Type == 'B' }
rule deep_leaf { Resources.*.Properties.n exists }
rule wrong_type { Resources.*.Type == 'C' }
"""

# the port's CLI; then, on stderr, its recursion limit and any module
# of jax or guard_tpu it imported
_PORT = (
    "import sys\n"
    "from guard_tpu_torch.cli import run\n"
    "rc = run(sys.argv[1:])\n"
    "sys.stdout.flush()\n"
    "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu'))\n"
    "print('LIMIT', sys.getrecursionlimit(), 'LEAKED', leaked, file=sys.stderr)\n"
    "sys.exit(rc)\n"
)


def nested(depth):
    leaf = {"n": 1}
    for _ in range(depth):
        leaf = {"n": leaf}
    return {"Resources": {"r": {"Type": "B", "Properties": leaf}}}


def yaml_block(depth):
    lines = ["Resources:", "  r:", "    Type: B", "    Properties:"]
    indent = 6
    for _ in range(depth):
        lines.append(" " * indent + "n:")
        indent += 1
    lines.append(" " * indent + "n: 1")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def deep_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("deep")
    (d / "rules.guard").write_text(RULES)
    out = {}
    for depth in (1000, 3000):
        (d / f"json{depth}").mkdir()
        (d / f"json{depth}" / "doc.json").write_text(json.dumps(nested(depth)))
        (d / f"yaml{depth}").mkdir()
        (d / f"yaml{depth}" / "doc.yaml").write_text(yaml_block(depth))
        out[("json", depth)] = d / f"json{depth}"
        out[("yaml", depth)] = d / f"yaml{depth}"
    return d / "rules.guard", out


def run(argv, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, *argv], cwd=str(ROOT), env=env, text=True,
                          capture_output=True, timeout=600)


# (the port's flags, the JAX CLI's backend)
PATHS = {"host": (["--backend", "cpu"], "cpu"), "device": (["--device", "cpu"], "tpu")}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("depth", [1000, 3000])
@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_deep_document_gives_the_jax_cli_bytes(deep_files, fmt, depth, path):
    rules, data = deep_files
    flags, jax_backend = PATHS[path]
    args = ["validate", "-S", "all", "-r", str(rules), "-d", str(data[(fmt, depth)])]
    want = run(["-m", "guard_tpu.cli", *args, "--backend", jax_backend],
               {"GUARD_TPU_RESULT_CACHE": "0", "GUARD_TPU_INGEST_WORKERS": "0"})
    got = run(["-c", _PORT, *args, *flags, "--no-result-cache", "--ingest-workers", "0"], {})
    assert "recursion" not in got.stderr, got.stderr[-2000:]
    assert got.stderr.rstrip().endswith("LIMIT 20000 LEAKED []"), got.stderr[-2000:]
    assert (got.returncode, got.stdout) == (want.returncode, want.stdout), (
        got.stderr[-2000:], want.stderr[-2000:])
    assert want.returncode == 19 and "wrong_type" in want.stdout


def test_import_raises_the_recursion_limit_in_a_fresh_process():
    code = ("import sys\n"
            "before = sys.getrecursionlimit()\n"
            "import guard_tpu_torch\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'guard_tpu'))\n"
            "print(before, sys.getrecursionlimit(), callable(guard_tpu_torch.run_checks), leaked)\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), text=True,
                         capture_output=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout.split() == ["1000", "20000", "True", "[]"]


def test_the_two_packages_export_the_same_names():
    assert guard_tpu_torch.__all__ == guard_tpu.__all__
    for name in guard_tpu_torch.__all__:
        assert getattr(guard_tpu_torch, name) is not None
    assert [s.name for s in guard_tpu_torch.Status] == [s.name for s in guard_tpu.Status]


def corpus_pair(name):
    spec = CORPUS / "tests" / f"{pathlib.Path(name).stem}_tests.yaml"
    cases = [c for c in (yaml.safe_load(spec.read_text()) or [])
             if isinstance(c, dict) and "input" in c]
    return (CORPUS / name).read_text(), json.dumps(cases[0]["input"])


def outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # both packages must raise alike
        return type(e).__name__, str(e)


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("name", CORPUS_SAMPLE)
def test_run_checks_matches_jax(name, verbose):
    rules, data = corpus_pair(name)
    kw = dict(verbose=verbose, data_file_name="input.json", rules_file_name=name)
    want = outcome(guard_tpu.run_checks, data, rules, **kw)
    got = outcome(guard_tpu_torch.run_checks, data, rules, **kw)
    assert got == want
    assert want[0] == "ok"


def test_corpus_sample_is_every_tenth_file():
    assert len(CORPUS_SAMPLE) == 25
