"""`completions` in the port (guard_tpu_torch/commands/completions.py)
against the JAX package's, on the CPU.

Both generate their scripts from their own argparse parser. Applied to
the JAX parser's surface, the port's generators give the JAX bytes for
bash, zsh and fish. The port's own surface is the JAX one with the
commands in the same order; it differs only by the flags in
PORT_ONLY_FLAGS and by its program name, and its CLI's script is the
JAX CLI's script with those two differences.
"""

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.commands import completions as jax_completions
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.commands import completions as port_completions
from guard_tpu_torch.utils.io import Reader, Writer

SHELLS = ["bash", "zsh", "fish"]
GENERATORS = {"bash": "_bash", "zsh": "_zsh", "fish": "_fish"}
#: the port's flags that the JAX CLI does not have, by command
PORT_ONLY_FLAGS = {
    "validate": ["--device"],
    "test": ["--device"],
    "sweep": ["--device"],
    "serve": ["--device"],
}
JAX_PROG = "guard-tpu"


def run_jax(args):
    w = JaxWriter.buffered()
    rc = jax_cli.run(["completions", *args], writer=w, reader=JaxReader())
    return rc, w.out.getvalue(), w.err.getvalue()


def run_port(args):
    w = Writer.buffered()
    rc = port_cli.run(["completions", *args], writer=w, reader=Reader())
    return rc, w.out.getvalue(), w.err.getvalue()


def strip_port_only(surface):
    return {
        cmd: [f for f in flags if f not in PORT_ONLY_FLAGS.get(cmd, [])]
        for cmd, flags in surface.items()
    }


@pytest.mark.parametrize("shell", SHELLS)
def test_generator_on_the_jax_surface_gives_the_jax_bytes(shell):
    surface = jax_completions.cli_surface()
    want = getattr(jax_completions, GENERATORS[shell])(JAX_PROG, surface)
    got = getattr(port_completions, GENERATORS[shell])(JAX_PROG, surface)
    assert got == want
    assert run_jax(["--shell", shell]) == (0, want, "")


def test_port_surface_is_the_jax_surface_plus_its_listed_flags():
    port = port_completions.cli_surface()
    jax = jax_completions.cli_surface()
    assert list(port) == list(jax)
    assert strip_port_only(port) == jax
    for cmd, extra in PORT_ONLY_FLAGS.items():
        assert all(f in port[cmd] for f in extra), cmd


@pytest.mark.parametrize("shell", SHELLS)
def test_port_cli_script_differs_only_by_the_listed_flags(shell):
    rc, out, err = run_port(["--shell", shell])
    assert rc == 0 and err == ""
    surface = port_completions.cli_surface()
    gen = getattr(port_completions, GENERATORS[shell])
    assert out == gen(port_cli.PROG, surface)
    # the same script once the port's flags and program name are taken out
    assert gen(JAX_PROG, strip_port_only(surface)) == run_jax(["--shell", shell])[1]
    for cmd in ("lint", "completions", "sweep"):
        assert cmd in out


@pytest.mark.parametrize("flag", ["-s", "--shell"])
def test_short_flag_and_default(flag):
    assert run_port([flag, "fish"])[1] == run_port(["--shell", "fish"])[1]
    assert run_port([])[1] == run_port(["--shell", "bash"])[1]


def test_unknown_shell_is_refused_like_jax():
    with pytest.raises(SystemExit) as jax_exit:
        run_jax(["--shell", "tcsh"])
    with pytest.raises(SystemExit) as port_exit:
        run_port(["--shell", "tcsh"])
    assert port_exit.value.code == jax_exit.value.code == 2
    w = Writer.buffered()
    assert port_completions.Completions(shell="tcsh").execute(w, Reader()) == 1
    assert w.err.getvalue() == "unsupported shell tcsh\n"
