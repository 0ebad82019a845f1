"""The port's coverage-guided parser fuzzer (guard_tpu_torch/tools/fuzz.py).

  * The smoke per target: an 8 s run exits 0 with no crash, over 1,000
    executions and over 300 covered lines of the port's package, and
    writes no crash file.
  * Parser parity: 2,000 seeded mutated payloads per target give the
    same `run_checks` string in both packages, or the same error class
    and message (object addresses and the package's name masked).
  * The fuzzer's process imports no jax and nothing of the JAX package.
"""

import pathlib
import random
import re
import subprocess
import sys

import pytest

from guard_tpu_torch.tools import fuzz as port_fuzz

REPO = pathlib.Path(__file__).resolve().parent.parent
N_PARITY = 2000


@pytest.mark.parametrize("target", ["dsl", "yaml"])
def test_fuzz_smoke(target, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "guard_tpu_torch.tools.fuzz", "--target", target,
         "--time", "8", "--crash-dir", str(tmp_path / "crashes")],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    m = re.search(r"executions=(\d+) corpus=(\d+) coverage=(\d+) crashes=(\d+)", proc.stdout)
    assert m, proc.stdout
    executions, corpus, coverage, crashes = map(int, m.groups())
    assert crashes == 0
    assert executions > 1000, "fuzzer throughput collapsed"
    assert coverage > 300, "coverage feedback not wired"
    assert corpus > 0
    assert not (tmp_path / "crashes").exists()


def _outcome(run_checks, error_type, target, payload):
    """The result string, or (error class, message) with object
    addresses and the package's name masked."""
    try:
        if target == "dsl":
            return run_checks(port_fuzz.FIXED_DATA, payload, verbose=False,
                              data_file_name="f.json", rules_file_name="f.guard")
        return run_checks(payload, port_fuzz.FIXED_RULES, verbose=False,
                          data_file_name="f.yaml", rules_file_name="f.guard")
    except (error_type, RecursionError) as e:
        msg = re.sub(r" at 0x[0-9a-f]+", " at 0x", str(e)).replace("guard_tpu_torch.", "guard_tpu.")
        return type(e).__name__, msg


@pytest.mark.parametrize("target", ["dsl", "yaml"])
def test_mutated_payloads_match_the_jax_package(target):
    from guard_tpu.api import run_checks as jax_run_checks
    from guard_tpu.core.errors import GuardError as JaxGuardError
    from guard_tpu_torch.api import run_checks
    from guard_tpu_torch.core.errors import GuardError

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import fuzz as jax_tool
    finally:
        sys.path.remove(str(REPO / "tools"))
    assert port_fuzz.TOKENS == jax_tool.TOKENS
    assert (port_fuzz.FIXED_DATA, port_fuzz.FIXED_RULES) == (jax_tool.FIXED_DATA,
                                                               jax_tool.FIXED_RULES)
    corpus = port_fuzz.seed_corpus(target)
    if not pathlib.Path("/root/reference").exists():
        assert corpus == jax_tool.seed_corpus(target)
    rng = random.Random(17)
    errors = 0
    for i in range(N_PARITY):
        payload = port_fuzz.mutate(rng, corpus)
        port = _outcome(run_checks, GuardError, target, payload)
        jax = _outcome(jax_run_checks, JaxGuardError, target, payload)
        assert port == jax, f"payload {i}: {payload!r}"
        errors += isinstance(port, tuple)
    assert 0 < errors < N_PARITY  # both outcomes are exercised


def test_fuzzer_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from guard_tpu_torch.tools.fuzz import main\n"
        "rc = main(sys.argv[1:])\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu'))\n"
        "print('LEAKED', leaked)\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, "--target", "yaml", "--time", "1",
         "--crash-dir", str(tmp_path / "crashes")],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
    assert "crashes=0" in proc.stdout
