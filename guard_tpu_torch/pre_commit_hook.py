"""pre-commit hook entry point of the port: the counterpart of the JAX
package's pre_commit_hooks/guard_tpu_hook.py.

It exposes the `validate` and `test` commands to pre-commit through the
port's in-process CLI (`cli.run`); every flag after `--operation` goes
to the command, `--device cpu` included. `.pre-commit-hooks.yaml`
lists it as the hook `guard-tpu-torch`:

    python -m guard_tpu_torch.pre_commit_hook --operation validate -r rules.guard -d templates/
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

# the JAX hook's message, byte for byte
UNKNOWN_OPERATION_MSG = (
    "Unknown operation. guard-tpu pre-commit-hook only supports validate "
    "and test commands."
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="guard-tpu-torch-hook", add_help=False)
    parser.add_argument("--operation", default="validate")
    args, rest = parser.parse_known_args(argv)
    if args.operation not in ("validate", "test"):
        print(UNKNOWN_OPERATION_MSG, file=sys.stderr)
        return 1
    from .cli import run

    return run([args.operation, *rest])


if __name__ == "__main__":
    sys.exit(main())
