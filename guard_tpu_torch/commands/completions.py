"""The `completions` command: shell completion scripts.

Equivalent of `guard/src/commands/completions.rs:31-41`
(clap_complete): emits bash / zsh / fish completion definitions for the
port's CLI (program name `guard-tpu-torch`). Like clap_complete,
everything is GENERATED from the parser definition (cli.build_parser) —
subcommands and flags cannot drift from the argparse surface.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Dict, List

from ..utils.io import Reader, Writer


def cli_surface() -> Dict[str, List[str]]:
    """{subcommand: [--long-flags...]} introspected from the port's
    argparse parser (the generate-from-parser design of
    completions.rs:31-41): the JAX package's commands and flags, and
    the port's `--device` on the commands that take it."""
    from ..cli import build_parser  # deferred: cli imports this module

    parser = build_parser()
    sub = next(
        a for a in parser._actions if isinstance(a, argparse._SubParsersAction)
    )
    out: Dict[str, List[str]] = {}
    for name, sp in sub.choices.items():
        flags: List[str] = []
        for action in sp._actions:
            flags.extend(o for o in action.option_strings if o.startswith("--"))
        out[name] = flags
    return out


def subcommands(surface: Dict[str, List[str]]) -> List[str]:
    return list(surface) + ["help"]


def _bash(prog: str, surface: Dict[str, List[str]]) -> str:
    cases = []
    for cmd, flags in surface.items():
        cases.append(
            f'        {cmd})\n            COMPREPLY=( $(compgen -W "{" ".join(flags)}" -- "$cur") )\n            return 0;;'
        )
    return f"""_guard_tpu() {{
    local cur prev cmd
    COMPREPLY=()
    cur="${{COMP_WORDS[COMP_CWORD]}}"
    cmd="${{COMP_WORDS[1]}}"
    if [ "$COMP_CWORD" -eq 1 ]; then
        COMPREPLY=( $(compgen -W "{" ".join(subcommands(surface))}" -- "$cur") )
        return 0
    fi
    case "$cmd" in
{chr(10).join(cases)}
    esac
}}
complete -F _guard_tpu {prog}
"""


def _zsh(prog: str, surface: Dict[str, List[str]]) -> str:
    lines = [f"#compdef {prog}", "_arguments -C \\"]
    lines.append('  "1: :(' + " ".join(subcommands(surface)) + ')" \\')
    lines.append('  "*::arg:->args"')
    return "\n".join(lines) + "\n"


def _fish(prog: str, surface: Dict[str, List[str]]) -> str:
    out = []
    for cmd in subcommands(surface):
        out.append(
            f"complete -c {prog} -n '__fish_use_subcommand' -a {cmd}"
        )
        for flag in surface.get(cmd, []):
            out.append(
                f"complete -c {prog} -n '__fish_seen_subcommand_from {cmd}' -l {flag.lstrip('-')}"
            )
    return "\n".join(out) + "\n"


@dataclass
class Completions:
    shell: str = "bash"

    def execute(self, writer: Writer, reader: Reader) -> int:
        from ..cli import PROG

        prog = PROG
        surface = cli_surface()
        if self.shell == "bash":
            writer.write(_bash(prog, surface))
        elif self.shell == "zsh":
            writer.write(_zsh(prog, surface))
        elif self.shell == "fish":
            writer.write(_fish(prog, surface))
        else:
            writer.writeln_err(f"unsupported shell {self.shell}")
            return 1
        return 0
