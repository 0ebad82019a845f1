"""The port's `test` command (guard_tpu_torch/commands/test.py and the
`test` subcommand of its cli.py) against the JAX package's, on the CPU.

The port runs with its default backend, `tpu` on `--device cpu` (the
plain kernels), and with `cpu` and `auto`; the JAX package runs with
`--backend cpu` (pure Python), and with `--backend tpu` on a seeded
sample of five corpus files. Every corpus rules file with its tests,
the whole corpus directory, `-v` and the argument errors give the same
stdout, stderr and rc (no tolerance: equal bytes). A device error on
the port's device path ends the run with code 1: no catch-all hands
the specs to the oracle.
"""

import os
import pathlib
import random
import subprocess
import sys

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.commands import test as port_test
from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
from guard_tpu_torch.utils.io import Writer
from test_torch_reports import set_native

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus" / "rules"
RULE_FILES = sorted(p.name for p in CORPUS.glob("*.guard"))
FORMATS = ("single-line-summary", "json", "junit")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    set_native(monkeypatch, None)


class _Recording(port_test.Test):
    """The port's Test, remembering the last instance run."""

    last = None

    def execute(self, writer, reader):
        _Recording.last = self
        return super().execute(writer, reader)


def run_jax(args, backend="cpu"):
    w = JaxWriter.buffered()
    rc = jax_cli.run(["test", "--backend", backend, *args], writer=w)
    return rc, w.stripped(), w.err_to_stripped()


def run_port(args, backend=None):
    w = Writer.buffered()
    extra = [] if backend is None else ["--backend", backend]
    _Recording.last = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cli, "Test", _Recording)
        rc = port_cli.run(["test", "--device", "cpu", *extra, *args], writer=w)
    return rc, w.stripped(), w.err_to_stripped()


def file_args(name):
    return ["-r", str(CORPUS / name), "-t", str(CORPUS / "tests" / f"{name[:-6]}_tests.yaml")]


@pytest.mark.parametrize("name", RULE_FILES)
def test_corpus_file_matches_jax(name):
    """One rules file with its tests, in the three formats: the port's
    device path (tpu, the plain kernels) against the JAX package's CPU
    evaluator."""
    for fmt in FORMATS:
        args = [*file_args(name), "-o", fmt]
        assert run_port(args) == run_jax(args), fmt


@pytest.mark.parametrize("fmt", FORMATS + ("yaml",))
def test_corpus_directory_matches_jax(fmt):
    """`test --dir` over all 249 files: their 725 cases, most of them
    answered on the device."""
    args = ["-d", str(CORPUS), "-o", fmt]
    got = run_port(args)
    assert got == run_jax(args)
    routes = _Recording.last.routes
    assert sum(routes.values()) == 725 and routes["native"] == 0
    assert routes["device"] >= 600


@pytest.mark.parametrize("backend", ["cpu", "auto"])
def test_host_backends_match_jax(backend):
    args = ["-d", str(CORPUS)]
    assert run_port(args, backend) == run_jax(args, backend)
    assert _Recording.last.routes["device"] == 0


def test_jax_device_path_sample_matches():
    """A seeded sample of five files against the JAX package's own
    `--backend tpu` (the JAX device path on the CPU)."""
    for name in random.Random(20261017).sample(RULE_FILES, 5):
        for fmt in ("single-line-summary", "json"):
            args = [*file_args(name), "-o", fmt]
            assert run_port(args) == run_jax(args, "tpu"), (name, fmt)


@pytest.mark.parametrize("name", ["block_form_050.guard", "conjunction_057.guard",
                                  "disjunction_056.guard"])
def test_verbose_matches_jax(name):
    args = [*file_args(name), "-v"]
    assert run_port(args) == run_jax(args)


@pytest.mark.parametrize("case", ["dir_and_rules", "nothing", "rules_only", "missing_rules",
                                  "missing_dir", "bad_spec"])
def test_argument_errors_match_jax(tmp_path, case):
    (tmp_path / "bad.yaml").write_text("[1, 2\n")
    args = {
        "dir_and_rules": ["-d", str(CORPUS), "-r", str(CORPUS / RULE_FILES[0])],
        "nothing": [],
        "rules_only": ["-r", str(CORPUS / RULE_FILES[0])],
        "missing_rules": ["-r", str(tmp_path / "none.guard"), "-t", str(tmp_path / "bad.yaml")],
        "missing_dir": ["-d", str(tmp_path / "none")],
        "bad_spec": ["-r", str(CORPUS / RULE_FILES[0]), "-t", str(tmp_path / "bad.yaml")],
    }[case]
    got = run_port(args)
    assert got == run_jax(args)
    assert got[0] in (0, 1, 5)


@pytest.mark.parametrize("name", RULE_FILES[:3])
def test_device_error_ends_the_run(monkeypatch, name):
    """No catch-all: an evaluator that raises ends `test` with rc 1 and
    the error on stderr, where the JAX package would quietly answer
    every spec from its oracle."""

    def broken(self, batch):
        raise RuntimeError("CUDA kernel gather_rows failed to launch (cudaError 700)")

    monkeypatch.setattr(DeviceBatchEvaluator, "evaluate_bucketed", broken)
    args = file_args(name)
    rc, out, err = run_port(args)
    assert rc == 1
    assert err == "Error: CUDA kernel gather_rows failed to launch (cudaError 700)\n"
    oracle = run_port(args, "cpu")
    assert oracle[0] != 1 and out != oracle[1]


def test_no_card_without_device_is_an_error(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = Writer.buffered()
    rc = port_cli.run(["test", *file_args(RULE_FILES[0])], writer=w)
    assert rc == 1 and "CUDA" in w.err_to_stripped()


def test_encode_failure_goes_to_the_oracle(monkeypatch):
    """A batch that fails to encode is one of the documented reasons:
    its specs are answered by the oracle, with the same bytes."""
    from guard_tpu_torch.ops import encoder

    def failing(*a, **k):
        raise ValueError("unencodable")

    monkeypatch.setattr(encoder, "encode_batch", failing)
    args = ["-d", str(CORPUS)]
    assert run_port(args) == run_jax(args)
    assert _Recording.last.routes["device"] == 0


def test_a_test_run_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        "from guard_tpu_torch.utils.io import Writer\n"
        f"rc = cli.run(['test', '--device', 'cpu', '-d', {str(CORPUS)!r}],\n"
        "             writer=Writer.buffered())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu'))\n"
        "print('RESULT', rc, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert [l for l in proc.stdout.splitlines() if l.startswith("RESULT")] == ["RESULT 0 []"], \
        proc.stderr[-2000:]
