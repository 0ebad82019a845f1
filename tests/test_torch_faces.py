"""The port's outside faces against the JAX package's, on the CPU.

  * The pre-commit hook (guard_tpu_torch/pre_commit_hook.py against
    pre_commit_hooks/guard_tpu_hook.py): `validate` and `test`, on the
    port's device path (`--device cpu`) and off it (`--backend cpu`),
    and an unknown operation give the same rc, stdout and stderr.
  * The GitHub Action (guard_tpu_torch/action/main.py against
    action/main.py): the six scenarios of tests/test_action.py (analyze,
    push, a pull request's review comments, its stale duplicates, its
    unrelated files, compliant data), on fixtures made here, through the
    same recording fake of `GithubApi.request`, record the same API
    calls (the uploaded SARIF decoded: gzip stamps the time) and write
    the same job summary, SARIF file, stdout and rc.
  * The library example (guard_tpu_torch/examples/library.py against
    examples/library.py): the same stdout; without a card and without
    `--device` it ends non-zero.
  * The C ABI (guard_tpu_torch/csrc/host/guard_ffi.c, built by
    guard_tpu_torch.ffi.build_ffi into a temporary directory, against
    native/guard_ffi.c built beside it): a C caller gets the same JSON
    from both, on the JAX test binary's pair and on corpus pairs, plain
    and verbose, and the port's own test binary prints the JAX one's
    bytes. Skipped only where gcc or python3-config is missing, as
    tests/test_ffi.py is.
  * The packaging: pyproject.toml's `guard-tpu-torch` script names a
    callable `guard_tpu_torch.cli:main` beside the unchanged
    `guard-tpu`, and .pre-commit-hooks.yaml lists both hooks.
"""

import base64
import gzip
import importlib
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tomllib

import pytest
import torch
import yaml

from guard_tpu_torch import pre_commit_hook as port_hook
from pre_commit_hooks import guard_tpu_hook as jax_hook

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus" / "rules"

RULES = """
rule S3_BUCKET_PUBLIC_ACCESS_BLOCKED {
    Resources.*[ Type == 'AWS::S3::Bucket' ] {
        Properties.PublicAccessBlockConfiguration exists
        <<
            every bucket blocks public access
        >>
    }
}

rule S3_BUCKET_VERSIONED {
    Resources.*[ Type == 'AWS::S3::Bucket' ] {
        Properties.VersioningConfiguration.Status == 'Enabled'
    }
}
"""

NON_COMPLIANT = """\
Resources:
  logs:
    Type: AWS::S3::Bucket
    Properties:
      VersioningConfiguration:
        Status: Suspended
  open:
    Type: AWS::S3::Bucket
    Properties:
      BucketName: wide-open
"""

COMPLIANT = """\
Resources:
  logs:
    Type: AWS::S3::Bucket
    Properties:
      PublicAccessBlockConfiguration:
        BlockPublicAcls: true
      VersioningConfiguration:
        Status: Enabled
"""


@pytest.fixture
def fixtures(tmp_path):
    rules = tmp_path / "s3.guard"
    rules.write_text(RULES)
    data = tmp_path / "data"
    data.mkdir()
    (data / "non-compliant.yaml").write_text(NON_COMPLIANT)
    (data / "compliant.yaml").write_text(COMPLIANT)
    return rules, data


# ---------------------------------------------------------------------------
# the pre-commit hook
# ---------------------------------------------------------------------------

def hook_outcome(main, argv, capfd):
    rc = main(argv)
    out, err = capfd.readouterr()
    return rc, out, err


# (the JAX hook's extra flags, the port hook's)
HOOK_PATHS = {"device": (["--backend", "cpu"], ["--device", "cpu", "--no-result-cache"]),
              "host": (["--backend", "cpu"], ["--backend", "cpu", "--no-result-cache"])}


@pytest.mark.parametrize("path", list(HOOK_PATHS))
def test_hook_validate_matches_jax(fixtures, capfd, path):
    rules, data = fixtures
    jax_flags, port_flags = HOOK_PATHS[path]
    args = ["--operation", "validate", "-S", "all", "-r", str(rules), "-d", str(data)]
    want = hook_outcome(jax_hook.main, args + jax_flags, capfd)
    got = hook_outcome(port_hook.main, args + port_flags, capfd)
    assert got == want
    assert want[0] == 19 and "S3_BUCKET_VERSIONED" in want[1]


@pytest.mark.parametrize("path", list(HOOK_PATHS))
def test_hook_test_matches_jax(capfd, path):
    name = "block_form_050"
    jax_flags, port_flags = HOOK_PATHS[path]
    port_flags = [f for f in port_flags if f != "--no-result-cache"]
    args = ["--operation", "test", "-r", str(CORPUS / f"{name}.guard"),
            "-t", str(CORPUS / "tests" / f"{name}_tests.yaml")]
    want = hook_outcome(jax_hook.main, args + jax_flags, capfd)
    got = hook_outcome(port_hook.main, args + port_flags, capfd)
    assert got == want
    assert want[0] == 0 and "PASS" in want[1]


def test_hook_unknown_operation_matches_jax(capfd):
    args = ["--operation", "rulegen", "-r", "x.guard"]
    want = hook_outcome(jax_hook.main, args, capfd)
    got = hook_outcome(port_hook.main, args, capfd)
    assert got == want == (1, "", jax_hook.UNKNOWN_OPERATION_MSG + "\n")


def test_hook_runs_as_the_yaml_entry_says():
    entry = yaml.safe_load((ROOT / ".pre-commit-hooks.yaml").read_text())[1]["entry"]
    got = subprocess.run([sys.executable, *entry.split()[1:], "--operation", "bogus"],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert (got.returncode, got.stdout) == (1, "")
    assert got.stderr == port_hook.UNKNOWN_OPERATION_MSG + "\n"


# ---------------------------------------------------------------------------
# the GitHub Action
# ---------------------------------------------------------------------------

def load_action(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_ACTION = load_action(ROOT / "action" / "main.py", "jax_action_main")
PORT_ACTION = load_action(ROOT / "guard_tpu_torch" / "action" / "main.py", "port_action_main")


class FakeApi:
    """tests/test_action.py's recording fake: records every request and
    returns scripted responses."""

    def __init__(self, responses=None):
        self.calls = []
        self.responses = responses or {}

    def request(self, method, path, body=None):
        self.calls.append((method, path, body))
        for (m, frag), resp in self.responses.items():
            if m == method and frag in path:
                return resp
        return {}


def decoded(calls):
    """The calls with an uploaded SARIF decoded (gzip stamps the time)."""
    out = []
    for method, path, body in calls:
        if body and "sarif" in body:
            body = dict(body, sarif=json.loads(gzip.decompress(base64.b64decode(body["sarif"]))))
        out.append((method, path, body))
    return out


@pytest.fixture
def action_env(tmp_path, fixtures, monkeypatch):
    rules, data = fixtures
    monkeypatch.chdir(tmp_path)  # the SARIF file lands in cwd
    monkeypatch.setenv("GITHUB_REPOSITORY", "octo/repo")
    monkeypatch.setenv("GITHUB_SHA", "deadbeef")
    monkeypatch.setenv("GITHUB_REF", "refs/heads/main")
    monkeypatch.setenv("GITHUB_STEP_SUMMARY", str(tmp_path / "summary.md"))
    monkeypatch.setenv("INPUT_RULES", str(rules))
    monkeypatch.setenv("INPUT_DATA", str(data / "non-compliant.yaml"))
    monkeypatch.setenv("INPUT_TOKEN", "tok")
    for k in ("INPUT_ANALYZE", "INPUT_CREATE_REVIEW", "INPUT_PATH", "INPUT_DEVICE",
              "GITHUB_EVENT_PATH"):
        monkeypatch.delenv(k, raising=False)
    return tmp_path


def action_run(module, env, monkeypatch, capsys, responses, device=None):
    """(rc, decoded calls, summary, SARIF file, stdout) of one run."""
    for f in ("summary.md", "guard-tpu.sarif"):
        (env / f).unlink(missing_ok=True)
    if device:
        monkeypatch.setenv("INPUT_DEVICE", device)
    else:
        monkeypatch.delenv("INPUT_DEVICE", raising=False)
    api = FakeApi(responses)
    capsys.readouterr()
    rc = module.main(api=api)
    summary = (env / "summary.md").read_text() if (env / "summary.md").exists() else None
    sarif = (env / "guard-tpu.sarif").read_text() if (env / "guard-tpu.sarif").exists() else None
    return rc, decoded(api.calls), summary, sarif, capsys.readouterr().out


def violating(env):
    sarif = json.loads((env / "guard-tpu.sarif").read_text())
    first = sarif["runs"][0]["results"][0]
    loc = first["locations"][0]["physicalLocation"]
    return loc["artifactLocation"]["uri"], first["message"]["text"], loc["region"]["startLine"]


def pull_request(env, monkeypatch, create_review):
    event = env / "event.json"
    event.write_text(json.dumps({"pull_request": {"number": 7, "head": {"sha": "abc123"}}}))
    monkeypatch.setenv("GITHUB_EVENT_PATH", str(event))
    monkeypatch.setenv("GITHUB_EVENT_NAME", "pull_request")
    if create_review:
        monkeypatch.setenv("INPUT_CREATE_REVIEW", "true")


def scenario(name, env, monkeypatch, capsys, fixtures):
    """Set the scenario's inputs; return the fake's responses."""
    monkeypatch.setenv("GITHUB_EVENT_NAME", "push")
    if name == "analyze":
        monkeypatch.setenv("INPUT_ANALYZE", "true")
        return {}
    if name in ("push", "compliant"):
        if name == "compliant":
            monkeypatch.setenv("INPUT_DATA", str(fixtures[1] / "compliant.yaml"))
        return {}
    # the pull-request scenarios learn the violating file from a push run
    action_run(JAX_ACTION, env, monkeypatch, capsys, {})
    uri, text, line = violating(env)
    if name == "review":
        pull_request(env, monkeypatch, True)
        stale = {"id": 99, "body": None, "path": uri, "position": None}
        return {("GET", "/pulls/7/files"): [{"filename": uri}],
                ("GET", "/pulls/7/comments"): [stale]}
    if name == "stale_duplicate":
        pull_request(env, monkeypatch, True)
        dup = {"id": 42, "body": text, "path": uri, "position": line}
        return {("GET", "/pulls/7/files"): [{"filename": uri}],
                ("GET", "/pulls/7/comments"): [dup]}
    assert name == "unrelated"
    pull_request(env, monkeypatch, False)
    return {("GET", "/pulls/7/files"): [{"filename": "unrelated.yaml"}]}


# scenario: (rc, what the JAX run must show)
SCENARIOS = {
    "analyze": 1, "push": 1, "review": 1, "stale_duplicate": 1, "unrelated": 0, "compliant": 0,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_action_matches_jax(action_env, fixtures, monkeypatch, capsys, name):
    responses = scenario(name, action_env, monkeypatch, capsys, fixtures)
    want = action_run(JAX_ACTION, action_env, monkeypatch, capsys, responses)
    got = action_run(PORT_ACTION, action_env, monkeypatch, capsys, responses, device="cpu")
    assert got == want
    rc, calls, summary, _sarif, _out = want
    assert rc == SCENARIOS[name]
    if name == "analyze":
        (method, path, body), = calls
        assert (method, path) == ("POST", "/repos/octo/repo/code-scanning/sarifs")
        assert body["sarif"]["runs"][0]["results"]
    if name == "push":
        assert calls == [] and "S3_BUCKET_VERSIONED" in summary
    if name == "review":
        posts = [c[1] for c in calls if c[0] == "POST"]
        assert posts and set(posts) == {"/repos/octo/repo/pulls/7/reviews"}
    if name == "stale_duplicate":
        assert [c for c in calls if c[0] == "DELETE"] == [
            ("DELETE", "/repos/octo/repo/pulls/comments/42", None)]
    if name in ("unrelated", "compliant"):
        assert summary is None


def test_action_without_a_card_and_device_fails_the_job(action_env, fixtures, monkeypatch,
                                                         capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the action runs on it")
    monkeypatch.setenv("GITHUB_EVENT_NAME", "push")
    rc, calls, summary, sarif, out = action_run(PORT_ACTION, action_env, monkeypatch, capsys, {})
    assert (rc, calls, summary, sarif) == (1, [], None, None)
    assert out.startswith("::error::Action failure:") and "CUDA" in out


def test_action_yml_passes_the_device_input():
    spec = yaml.safe_load((ROOT / "guard_tpu_torch" / "action" / "action.yml").read_text())
    jax_spec = yaml.safe_load((ROOT / "action" / "action.yml").read_text())
    assert set(spec["inputs"]) == set(jax_spec["inputs"]) | {"device"}
    step = spec["runs"]["steps"][1]
    assert step["env"]["INPUT_DEVICE"] == "${{ inputs.device }}"
    assert step["run"] == "python ${{ github.action_path }}/main.py"


# ---------------------------------------------------------------------------
# the library example
# ---------------------------------------------------------------------------

def test_library_example_matches_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    want = subprocess.run([sys.executable, "examples/library.py"], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=600)
    got = subprocess.run([sys.executable, "-m", "guard_tpu_torch.examples.library",
                          "--device", "cpu"], cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=600)
    assert want.returncode == 0, want.stderr[-2000:]
    assert (got.returncode, got.stdout) == (0, want.stdout), got.stderr[-2000:]
    assert "builder payload exit code: 19" in want.stdout


def test_library_example_without_a_card_ends_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the example runs on it")
    got = subprocess.run([sys.executable, "-m", "guard_tpu_torch.examples.library"],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert got.returncode != 0 and "CUDA" in got.stderr
    assert "builder payload" not in got.stdout


# ---------------------------------------------------------------------------
# the C ABI
# ---------------------------------------------------------------------------

_CALLER = r"""
#include <stdio.h>
#include <stdlib.h>
#define CAT(a, b) a##b
#define XCAT(a, b) CAT(a, b)
#define RUN XCAT(PREFIX, _run_checks)
#define FREE XCAT(PREFIX, _free_string)

static char* slurp(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* s = malloc(n + 1);
  size_t got = fread(s, 1, n, f);
  s[got] = 0;
  fclose(f);
  return s;
}

/* argv: verbose, then (data path, rules path) pairs; one answer each */
int main(int argc, char** argv) {
  int verbose = atoi(argv[1]);
  for (int i = 2; i + 1 < argc; i += 2) {
    guard_validate_input_t data = {slurp(argv[i]), "input.json"};
    guard_validate_input_t rules = {slurp(argv[i + 1]), "rules.guard"};
    guard_extern_err_t err = {0, NULL};
    char* out = RUN(data, rules, verbose, &err);
    if (out == NULL) {
      printf("ERROR %d %s\n", err.code, err.message ? err.message : "?");
      FREE(err.message);
    } else {
      printf("%s\n", out);
      FREE(out);
    }
    printf("----\n");
    free((char*)data.content);
    free((char*)rules.content);
  }
  return 0;
}
"""

_HAVE_TOOLS = shutil.which("gcc") is not None and shutil.which("python3-config") is not None
needs_tools = pytest.mark.skipif(not _HAVE_TOOLS, reason="gcc or python3-config missing")

# the corpus pairs: every 25th rules file with its first test input
FFI_FILES = [p.stem for p in sorted(CORPUS.glob("*.guard"))[::25]]


def ffi_pairs(d: pathlib.Path):
    pairs = []
    (d / "empty.json").write_text('{"Resources": {}}')
    (d / "not_empty.guard").write_text("Resources !empty")
    pairs.append((d / "empty.json", d / "not_empty.guard"))
    for stem in FFI_FILES:
        cases = yaml.safe_load((CORPUS / "tests" / f"{stem}_tests.yaml").read_text())
        data = d / f"{stem}.json"
        data.write_text(json.dumps(cases[0]["input"]))
        pairs.append((data, CORPUS / f"{stem}.guard"))
    return pairs


@pytest.fixture(scope="module")
def ffi_answers(tmp_path_factory):
    """{(library, verbose): [answer per pair]} from one C caller process
    per library and flag, and both test binaries' output."""
    from guard_tpu_torch.ffi import build_ffi

    d = tmp_path_factory.mktemp("ffi")
    cflags = subprocess.run(["python3-config", "--includes"], check=True,
                            capture_output=True, text=True).stdout.split()
    ldflags = subprocess.run(["python3-config", "--ldflags", "--embed"], check=True,
                             capture_output=True, text=True).stdout.split()
    port = build_ffi(d / "port")
    jax_dir = d / "jax"
    jax_dir.mkdir()
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", *cflags, str(ROOT / "native" / "guard_ffi.c"),
                    "-o", str(jax_dir / "libguard_ffi.so"), *ldflags], check=True)
    subprocess.run(["gcc", "-O2", "-DGUARD_FFI_TEST_MAIN", *cflags,
                    str(ROOT / "native" / "guard_ffi.c"), "-o", str(jax_dir / "guard_ffi_test"),
                    *ldflags], check=True)
    (d / "caller.c").write_text(_CALLER)
    callers = {}
    for lib, prefix, header, libdir, name in (
            ("jax", "guard_tpu", ROOT / "native" / "guard_ffi.h", jax_dir, "guard_ffi"),
            ("port", "guard_tpu_torch", port["header"], port["lib"].parent,
             "guard_tpu_torch_ffi")):
        callers[lib] = d / f"caller_{lib}"
        subprocess.run(["gcc", "-O2", f"-DPREFIX={prefix}", "-include", str(header), *cflags,
                        str(d / "caller.c"), "-o", str(callers[lib]), f"-L{libdir}", f"-l{name}",
                        f"-Wl,-rpath,{libdir}", *ldflags], check=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    pairs = ffi_pairs(d)
    argv = [str(p) for pair in pairs for p in pair]
    answers = {}
    for lib, caller in callers.items():
        for verbose in (0, 1):
            got = subprocess.run([str(caller), str(verbose), *argv], env=env, capture_output=True,
                                 text=True, timeout=600)
            assert got.returncode == 0, got.stderr[-2000:]
            answers[(lib, verbose)] = got.stdout.split("----\n")[:-1]
            assert len(answers[(lib, verbose)]) == len(pairs)
    for lib, binary in (("jax", jax_dir / "guard_ffi_test"), ("port", port["test"])):
        got = subprocess.run([str(binary)], env=env, capture_output=True, text=True, timeout=600)
        assert got.returncode == 0, got.stderr[-2000:]
        answers[(lib, "test")] = got.stdout
    return answers


@needs_tools
@pytest.mark.parametrize("verbose", [0, 1])
@pytest.mark.parametrize("pair", range(1 + len(FFI_FILES)))
def test_ffi_caller_gets_the_jax_json(ffi_answers, pair, verbose):
    want = ffi_answers[("jax", verbose)][pair]
    got = ffi_answers[("port", verbose)][pair]
    assert got == want
    assert not want.startswith("ERROR")
    json.loads(want)


@needs_tools
def test_ffi_test_binaries_print_the_same_report(ffi_answers):
    assert ffi_answers[("port", "test")] == ffi_answers[("jax", "test")]
    reports = json.loads(ffi_answers[("port", "test")])
    assert reports[0]["status"] == "FAIL" and reports[0]["name"] == "data.json"


@needs_tools
def test_build_ffi_builds_once_and_exports_the_port_names(tmp_path):
    from guard_tpu_torch.ffi import build_ffi

    first = build_ffi(tmp_path)
    stamp = first["lib"].stat().st_mtime_ns
    assert build_ffi(tmp_path) == first and first["lib"].stat().st_mtime_ns == stamp
    if shutil.which("nm"):
        names = subprocess.run(["nm", "-D", "--defined-only", str(first["lib"])], check=True,
                               capture_output=True, text=True).stdout
        assert "guard_tpu_torch_run_checks" in names and "guard_tpu_torch_free_string" in names
        assert " guard_tpu_run_checks" not in names


# ---------------------------------------------------------------------------
# the packaging
# ---------------------------------------------------------------------------

def test_pyproject_installs_both_commands():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["guard-tpu"] == "guard_tpu.cli:main"
    assert scripts["guard-tpu-torch"] == "guard_tpu_torch.cli:main"
    module, _, attr = scripts["guard-tpu-torch"].partition(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_pre_commit_hooks_lists_both_hooks():
    hooks = yaml.safe_load((ROOT / ".pre-commit-hooks.yaml").read_text())
    assert [h["id"] for h in hooks] == ["guard-tpu", "guard-tpu-torch"]
    assert hooks[0]["entry"] == "python -m pre_commit_hooks.guard_tpu_hook"
    assert hooks[1]["entry"] == "python -m guard_tpu_torch.pre_commit_hook"
    for key in ("language", "verbose", "always_run", "pass_filenames"):
        assert hooks[1][key] == hooks[0][key]
