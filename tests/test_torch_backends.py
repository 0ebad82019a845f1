"""The validate backends off the device, against the JAX package.

`python -m guard_tpu_torch validate --backend cpu|native|auto` must
print the same stdout and stderr and exit with the same code as
`python -m guard_tpu.cli validate --backend <same>`: with the verbose
record tree (-v), the record JSON (-p), -i, -P, -a and every output
format, on the 15-document report fixture and on a fixed 25-file sample
of corpus/rules over its tests' inputs, with the native oracle built
and not built on both sides (test_torch_reports.py's fixtures set the
state; the library is built once per run into a temporary directory).
Also: `auto` resolves to `native` exactly when the port's oracle is
built; the native backend's build-failure message is the JAX package's;
`--statuses-only` off the tpu backend is refused as there; and a port
run on any backend imports no JAX, and off the device no torch.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bench
import __graft_entry__ as graft
from guard_tpu import cli as jax_cli
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.commands import validate as port_validate
from guard_tpu_torch.utils.io import Reader, Writer
from test_torch_reports import (  # noqa: F401  (fixtures)
    _computed_not_replayed,
    native_lib_dir,
    set_native,
    write_fixture,
)
from test_torch_reports_corpus import CORPUS, NATIVE_SAMPLE, corpus_data

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_both(backend, args, stdin=None):
    """Both CLIs' (rc, stdout, stderr) for `validate --backend backend`
    plus `args`; they must be equal."""
    w = JaxWriter.buffered()
    r = JaxReader.from_string(stdin if stdin is not None else "")
    rc = jax_cli.run(["validate", "--backend", backend, *args], writer=w, reader=r)
    want = (rc, w.stripped(), w.err_to_stripped())
    w = Writer.buffered()
    r = Reader.from_string(stdin if stdin is not None else "")
    rc = port_cli.run(["validate", "--no-result-cache", "--backend", backend, *args], writer=w, reader=r)
    got = (rc, w.stripped(), w.err_to_stripped())
    assert got[0] == want[0], (got[2], want[2])
    assert got[2] == want[2]
    assert got[1] == want[1]
    return got


@pytest.fixture
def oracle_built(monkeypatch, native_lib_dir):
    set_native(monkeypatch, native_lib_dir)


@pytest.fixture
def oracle_absent(monkeypatch):
    set_native(monkeypatch, None)


# the (backend, native oracle state) pairs: `native` needs the oracle
# (an absent one is built on first use, or refused: see below), `auto`
# resolves by the state
STATES = [("cpu", "oracle_absent"), ("auto", "oracle_absent"),
          ("auto", "oracle_built"), ("native", "oracle_built")]


def _payload() -> str:
    rng = np.random.default_rng(5)
    docs = [bench.make_template(rng, i) for i in range(5)]
    return json.dumps({
        "rules": [bench.RULES, graft._RULES, "rule broken {"],
        "data": [docs[0], json.dumps(docs[1]), *docs[2:]],
    })


FLAGS = {
    "show_fail": [],
    "show_all": ["-S", "all"],
    "json": ["-o", "json"],
    "yaml": ["-o", "yaml", "-S", "all"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
    "structured_yaml": ["-z", "-o", "yaml", "-S", "none"],
    "structured_sarif": ["-z", "-o", "sarif", "-S", "none"],
    "structured_junit": ["-z", "-o", "junit", "-S", "none"],
    "verbose": ["-v"],
    "print_json": ["-p"],
    "verbose_print_json_all": ["-v", "-p", "-S", "all"],
    "alphabetical": ["-a", "-v"],
    "input_params": ["-i", "{params}", "-p"],
    "payload": ["-P", "-v"],
}


@pytest.mark.parametrize("case", sorted(FLAGS))
@pytest.mark.parametrize("backend,state", STATES, ids=[f"{b}-{s}" for b, s in STATES])
def test_backend_flags_match_jax(request, tmp_path, backend, state, case):
    request.getfixturevalue(state)
    root = write_fixture(tmp_path)
    (root / "rules" / "params.guard").write_text(
        "let allowed = Params.sizes\n"
        "rule sizes_allowed when Resources exists {\n"
        "  Resources.*[ Type == 'AWS::EC2::Volume' ].Properties.Size IN %allowed\n"
        "}\n"
    )
    (root / "params.yaml").write_text("Params:\n  sizes: [8, 16, 64]\n")
    flags = [f.replace("{params}", str(root / "params.yaml")) for f in FLAGS[case]]
    stdin = None
    if case == "payload":
        args, stdin = flags, _payload()
    else:
        args = ["-r", str(root / "rules"), "-d", str(root / "data"), *flags]
    rc, out, err = run_both(backend, args, stdin)
    assert out
    if case == "payload":
        # off the device a rules file that does not parse is an error
        assert rc == 5 and "Parse Error on ruleset file RULES_STDIN[3]" in err
    else:
        assert rc == 19
    if "-v" in flags:
        assert "`- File(" in out
    if "-p" in flags:
        assert '"container": {' in out


@pytest.mark.parametrize("stem", NATIVE_SAMPLE)
@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_corpus_sample_matches_jax(request, tmp_path, backend, stem):
    request.getfixturevalue("oracle_built" if backend == "native" else "oracle_absent")
    data = corpus_data(stem, tmp_path)
    for mode in (["-S", "all", "-v"], ["-z", "-o", "json", "-S", "none"], ["-p"]):
        rc, _out, err = run_both(backend, ["-r", str(CORPUS / f"{stem}.guard"),
                                           "-d", str(data), *mode])
        assert rc in (0, 19, 5) and (rc == 5) == bool(err)


@pytest.mark.parametrize("state", ["oracle_absent", "oracle_built"])
def test_auto_resolves_to_native_exactly_when_built(request, state):
    from guard_tpu.commands.validate import resolve_backend as jax_resolve

    request.getfixturevalue(state)
    want = "native" if state == "oracle_built" else "cpu"
    assert port_validate.resolve_backend("auto") == jax_resolve("auto") == want
    for backend in ("cpu", "native", "tpu"):
        assert port_validate.resolve_backend(backend) == backend


def test_native_build_failure_matches_jax(oracle_absent, monkeypatch, tmp_path):
    """With the oracle absent and no way to build it, `--backend native`
    stops with the JAX package's message."""
    from guard_tpu.ops import native_oracle as jax_oracle
    from guard_tpu_torch.ops import native_oracle as port_oracle

    def no_compiler(force=False):
        raise RuntimeError("g++ failed to build libguard_oracle.so")

    monkeypatch.setattr(port_oracle, "build_native", no_compiler)
    monkeypatch.setattr(jax_oracle, "build_native", lambda force=False: False)
    root = write_fixture(tmp_path)
    rc, out, err = run_both("native", ["-r", str(root / "rules"), "-d", str(root / "data")])
    assert rc == 5 and out == ""
    assert err == ("Error: native backend requested but the compiled engine is not built "
                   "and could not be compiled (native/build_oracle.sh needs a C++ "
                   "toolchain); use --backend cpu\n")


@pytest.mark.parametrize("backend", ["cpu", "native", "auto"])
def test_statuses_only_needs_the_tpu_backend(oracle_absent, tmp_path, backend):
    root = write_fixture(tmp_path)
    rc, out, err = run_both(backend, ["-r", str(root / "rules"), "-d", str(root / "data"),
                                      "--statuses-only"])
    assert (rc, out, err) == (5, "", "Error: statuses-only requires the tpu backend\n")


def test_document_that_does_not_parse_matches_jax(oracle_built, tmp_path):
    """Eager loads (cpu) and the native backend's up-front validation
    stop on a document that parses as neither JSON nor YAML; flow-style
    YAML that is not JSON evaluates from its tree."""
    root = write_fixture(tmp_path)
    (root / "data" / "flow.json").write_text('{Resources: {b: {Type: "AWS::S3::Bucket"}}}')
    for backend in ("cpu", "native"):
        rc, _out, _err = run_both(backend, ["-r", str(root / "rules"), "-d", str(root / "data")])
        assert rc == 19
    (root / "data" / "zz_bad.json").write_text('{"Resources": [1, 2')
    for backend in ("cpu", "native"):
        rc, out, err = run_both(backend, ["-r", str(root / "rules"), "-d", str(root / "data")])
        assert rc == 5 and out == "" and err


@pytest.mark.parametrize("backend", ["cpu", "native", "auto", "tpu"])
def test_no_jax_and_off_the_device_no_torch(native_lib_dir, tmp_path, backend):
    """A port run imports no JAX on any backend, and no torch off the
    device (cpu, native and auto run no torch operation)."""
    root = write_fixture(tmp_path)
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        f"rc = cli.run(['validate', '--no-result-cache', '--backend', {backend!r},\n"
        f"             '--device', 'cpu',\n"
        f"             '--ingest-workers', '0', '-r', {str(root / 'rules')!r},\n"
        f"             '-d', {str(root / 'data')!r}])\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "print('RESULT', rc, sorted(mods & {'jax', 'jaxlib', 'guard_tpu', 'torch'}))\n"
    )
    env = dict(os.environ, GUARD_TPU_TORCH_NATIVE_DIR=str(native_lib_dir), PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    want = "['torch']" if backend == "tpu" else "[]"
    assert proc.stdout.strip().splitlines()[-1] == f"RESULT 19 {want}", proc.stderr[-2000:]
