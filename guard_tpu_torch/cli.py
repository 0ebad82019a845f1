"""Command-line interface of the torch port.

    python -m guard_tpu_torch validate --statuses-only -r RULES -d DATA \
        [--show-summary fail,pass,...] [--device cpu]

Same flags, stdout, stderr and exit codes (0 pass / 19 fail / 5 error)
as `python -m guard_tpu.cli validate --backend tpu --statuses-only` with
the JAX package's CPU evaluator as its oracle: the documents the device
cannot decide rerun on the port's CPU evaluator. Runs on the CUDA
device unless `--device` names another; with no card and no `--device`
it stops with code 5.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .commands.validate import ERROR_STATUS_CODE, Validate
from .core.errors import GuardError
from .utils.io import Reader, Writer

PROG = "guard-tpu-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Guard policy-as-code validation on a CUDA device "
        "(PyTorch port of the guard-tpu batch engine).",
    )
    sub = p.add_subparsers(dest="command")
    v = sub.add_parser("validate", help="Evaluates rules against data files")
    v.add_argument("--rules", "-r", nargs="*", default=[])
    v.add_argument("--data", "-d", nargs="*", default=[])
    v.add_argument("--show-summary", "-S", default="fail")
    v.add_argument("--last-modified", "-m", action="store_true")
    v.add_argument(
        "--statuses-only", action="store_true",
        help="report rule-level statuses without per-clause detail "
        "(required: the only mode of this port so far)",
    )
    v.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; `cpu` runs the "
        "plain versions of the kernels)",
    )
    return p


def run(argv: Optional[List[str]] = None, writer: Optional[Writer] = None,
        reader: Optional[Reader] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    writer = writer or Writer()
    reader = reader or Reader()
    if args.command is None:
        parser.print_help()
        return 0
    cmd = Validate(
        rules=args.rules,
        data=args.data,
        show_summary=args.show_summary.split(","),
        last_modified=args.last_modified,
        statuses_only=args.statuses_only,
        device=args.device,
    )
    try:
        return cmd.execute(writer, reader)
    except (GuardError, RuntimeError) as e:
        # argument errors, and no CUDA device without --device
        writer.writeln_err(str(e))
        return ERROR_STATUS_CODE


def main() -> None:
    code = run()
    sys.stdout.flush()
    sys.exit(code)


if __name__ == "__main__":
    main()
