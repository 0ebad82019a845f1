"""Command-line interface of the torch port.

    python -m guard_tpu_torch validate -r RULES -d DATA \
        [-o single-line-summary|json|yaml|junit|sarif] [-z] \
        [-S fail,pass,...] [-i PARAMS] [-P] [-a|-m] [-t TYPE] [-v] [-p] \
        [--backend tpu|cpu|native|auto] [--statuses-only] \
        [--ingest-workers N] [--max-doc-failures N] [--device cpu]

Same flags, stdout, stderr and exit codes (0 pass / 19 fail / 5 error)
as `python -m guard_tpu.cli validate` with the same flags and the same
`--backend`. The one difference is the default backend: `tpu` here (the
port's entry points run on the card), `auto` in the JAX package. On
`tpu` the walk and the rim run on the device, and the reports of the
documents that need one are built on the host by the native oracle
when it is built (ops/native_oracle.build_native), else by the port's
CPU evaluator; it runs on the CUDA device unless `--device` names
another, and with no card and no `--device` it stops with code 5.
`cpu`, `native` and `auto` evaluate on the host and need no card.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .commands.validate import ERROR_STATUS_CODE, OUTPUT_FORMATS, Validate
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
    v.add_argument("--input-params", "-i", nargs="*", default=[])
    # accepted and unused, as in the JAX package
    v.add_argument("--type", "-t", dest="template_type", default=None)
    v.add_argument(
        "--output-format", "-o", default="single-line-summary", choices=OUTPUT_FORMATS,
    )
    v.add_argument("--show-summary", "-S", default="fail")
    v.add_argument("--alphabetical", "-a", action="store_true")
    v.add_argument("--last-modified", "-m", action="store_true")
    v.add_argument("--verbose", "-v", action="store_true")
    v.add_argument("--print-json", "-p", action="store_true")
    v.add_argument("--payload", "-P", action="store_true")
    v.add_argument("--structured", "-z", action="store_true")
    v.add_argument(
        "--backend",
        default="tpu",
        choices=["auto", "cpu", "native", "tpu"],
        help="tpu (default) = the device path on the CUDA card; auto = "
        "compiled C++ engine when built, else pure-Python; native/cpu "
        "force one",
    )
    v.add_argument(
        "--statuses-only", action="store_true",
        help="report rule-level statuses without per-clause detail "
        "(no oracle rerun of the documents that fail on the device)",
    )
    v.add_argument(
        "--ingest-workers",
        type=int,
        default=None,
        help="tpu backend: worker processes for the parallel host "
        "read/parse/encode plane (default auto; 0 = serial bit-parity "
        "escape hatch; overrides GUARD_TPU_INGEST_WORKERS)",
    )
    v.add_argument(
        "--max-doc-failures",
        type=int,
        default=None,
        help="tpu backend: quarantine documents that fail to "
        "read/parse/encode instead of aborting; exit ERROR only when "
        "more than this many docs were quarantined (0 = quarantine "
        "records but any failing doc still fails the run; omit the "
        "flag for the historical abort-on-first-failure behavior)",
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
        input_params=args.input_params,
        output_format=args.output_format,
        show_summary=args.show_summary.split(","),
        alphabetical=args.alphabetical,
        last_modified=args.last_modified,
        verbose=args.verbose,
        print_json=args.print_json,
        payload=args.payload,
        structured=args.structured,
        backend=args.backend,
        statuses_only=args.statuses_only,
        ingest_workers=args.ingest_workers,
        max_doc_failures=args.max_doc_failures,
        device=args.device,
    )
    try:
        return cmd.execute(writer, reader)
    except (GuardError, OSError, RuntimeError) as e:
        # argument conflicts, a payload that does not parse, and no
        # CUDA device without --device
        writer.writeln_err(f"Error: {e}")
        return ERROR_STATUS_CODE


def main() -> None:
    code = run()
    sys.stdout.flush()
    sys.exit(code)


if __name__ == "__main__":
    main()
