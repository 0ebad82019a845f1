"""The port's npm package (guard_tpu_torch/ts_lib/): a GENERATED
CommonJS build of index.ts (`python -m guard_tpu_torch.tools.ts_build`)
that drives the `guard-tpu-torch` CLI.

  * The committed dist is the generated output, byte for byte, and
    holds no TypeScript.
  * It names the port's CLI and passes a backend on every call:
    `tpuBackend` true or left out gives `--backend tpu`, false gives
    `--backend cpu`; a call that passed none would reach the port's
    `tpu` default, which answers code 5 without a card.
  * The port's CLI honours the invocations index.ts makes and their exit
    codes: `--version` (the preflight banner), `validate --structured
    -S none -o sarif -r ... -d ... --backend tpu|cpu` (SARIF, 0 / 19 /
    5), and `serve --stdio` (one JSON line in, one out, in order).
  * Where `node` is installed, smoke.js runs the build end to end (it
    skips otherwise).
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TS_LIB = REPO / "guard_tpu_torch" / "ts_lib"


def test_dist_is_generated_and_current():
    proc = subprocess.run([sys.executable, "-m", "guard_tpu_torch.tools.ts_build", "--check"],
                          cwd=str(REPO), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_generated_js_has_no_typescript_residue():
    js = (TS_LIB / "dist" / "index.js").read_text()
    for pat in (
        r"\binterface\b",
        r"^import ",
        r"\bas\s+[A-Z]",
        r"as const",
        r"\?\s*:\s*\w+\s*[,)]",
        r":\s*Promise<",
    ):
        assert not re.search(pat, js, re.M), pat
    for name in ("validate", "createSession", "preflight", "EXIT_CODES"):
        assert f"exports.{name} = {name};" in js


def test_dist_drives_the_port_and_names_a_backend():
    js = (TS_LIB / "dist" / "index.js").read_text()
    ts = (TS_LIB / "index.ts").read_text()
    for src in (js, ts):
        assert src.count('?? "guard-tpu-torch"') == 3  # preflight, validate, createSession
        assert '"--backend", input.tpuBackend === false ? "cpu" : "tpu"' in src
        assert 'backend: opts.tpuBackend === false ? "cpu" : "tpu"' in src
        assert 'spawn(cli, ["serve", "--stdio"]' in src
        assert '"--structured"' in src and '"sarif"' in src and "validationFailure: 19" in src
        assert "guard_tpu." not in src and '"guard-tpu"' not in src
    pkg = json.loads((TS_LIB / "package.json").read_text())
    assert pkg["name"] == "guard-tpu-torch" and pkg["main"] == "dist/index.js"
    assert "guard_tpu_torch.tools.ts_build" in pkg["scripts"]["build"]
    for js_file in ("smoke.js", "scripts/postinstall.js", "__tests__/index.test.js"):
        text = (TS_LIB / js_file).read_text()
        assert "guard_tpu_torch" in text or "guard-tpu-torch" in text, js_file
        assert "guard_tpu.cli" not in text, js_file


def _cli(argv, stdin="", env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "guard_tpu_torch", *argv], cwd=str(REPO),
                          env=env, input=stdin, capture_output=True, text=True, timeout=300)


def test_version_answers_the_preflight_banner():
    proc = _cli(["--version"])
    assert proc.returncode == 0
    assert proc.stdout.strip() == "guard-tpu-torch 0.1.0"


@pytest.fixture
def files(tmp_path):
    rules = tmp_path / "r.guard"
    rules.write_text("rule has_res {\n  Resources !empty\n}\n")
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps({"Resources": {"a": 1}}))
    bad.write_text(json.dumps({"Other": 1}))
    return rules, good, bad


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_validate_sarif_invocation_and_exit_codes(files, backend):
    """The argv validate() builds: rc 19 with SARIF results on a failing
    document, 0 on a passing one."""
    from guard_tpu_torch.cli import run
    from guard_tpu_torch.utils.io import Reader, Writer

    rules, good, bad = files
    device = ["--device", "cpu"] if backend == "tpu" else []
    for data, want in (([good, bad], 19), ([good], 0)):
        w = Writer.buffered()
        code = run(["validate", "--structured", "-S", "none", "-o", "sarif", "-r", str(rules),
                    "-d", *map(str, data), "--backend", backend, *device],
                   writer=w, reader=Reader.from_string(""))
        assert code == want
        sarif = json.loads(w.stripped())
        assert sarif["version"] == "2.1.0"
        assert bool(sarif["runs"][0]["results"]) == (want == 19)


def test_validate_without_a_card_answers_code_5(files):
    """No card: the device path (a call that names `tpu`, or none) exits
    5, which is why index.ts names the backend on every call."""
    rules, good, bad = files
    argv = ["validate", "--structured", "-S", "none", "-o", "sarif", "-r", str(rules),
            "-d", str(good), str(bad)]
    no_card = {"CUDA_VISIBLE_DEVICES": ""}
    assert _cli(argv, env_extra=no_card).returncode == 5
    assert _cli([*argv, "--backend", "tpu"], env_extra=no_card).returncode == 5
    assert _cli([*argv, "--backend", "cpu"], env_extra=no_card).returncode == 19


def test_serve_stdio_answers_the_session_protocol():
    """createSession()'s request lines, one per validatePayload(): one
    JSON response line each, in order, with the SARIF output."""
    requests = [
        {"rules": ["rule ok { a exists }"], "data": ['{"a": 1}'], "output_format": "sarif",
         "backend": backend}
        for backend in ("tpu", "cpu")
    ] + [
        {"rules": ["rule ok { a exists }"], "data": ['{"b": 1}'], "output_format": "sarif",
         "backend": backend}
        for backend in ("tpu", "cpu")
    ]
    proc = _cli(["serve", "--stdio", "--device", "cpu"],
                stdin="".join(json.dumps(r) + "\n" for r in requests))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == len(requests)
    answers = [json.loads(line) for line in lines]
    assert [a["code"] for a in answers] == [0, 0, 19, 19]
    for a in answers:
        assert json.loads(a["output"])["version"] == "2.1.0"
    assert answers[0]["output"] == answers[1]["output"]
    assert answers[2]["output"] == answers[3]["output"]


@pytest.mark.skipif(shutil.which("node") is None, reason="node unavailable")
def test_smoke_under_node():
    proc = subprocess.run(["node", str(TS_LIB / "smoke.js")], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ts_lib smoke OK" in proc.stdout
    assert "session smoke OK" in proc.stdout
