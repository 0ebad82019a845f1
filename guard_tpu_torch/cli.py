"""Command-line interface of the torch port.

    python -m guard_tpu_torch validate -r RULES -d DATA \
        [-o single-line-summary|json|yaml|junit|sarif] [-z] \
        [-S fail,pass,...] [-i PARAMS] [-P] [-a|-m] [-t TYPE] [-v] [-p] \
        [--backend tpu|cpu|native|auto] [--statuses-only] [--no-pack] \
        [--ingest-workers N] [--max-doc-failures N] [--no-plan-cache] \
        [--no-verify-plans] [--device cpu]

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

The JAX package's `validate` flags not ported yet: `--no-result-cache`,
`--delta-stats`, `--no-vector-rim`, `--mesh-shape`, `--trace-out` and
`--metrics-out`.
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
        "--no-pack",
        action="store_true",
        help="tpu backend: disable fused multi-rule-file dispatch "
        "(evaluate each rule file through its own walk)",
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
        "--no-plan-cache",
        action="store_true",
        help="tpu backend: disable the compiled-plan artifact layer "
        "(re-lower the rule registry per call instead of reusing the "
        "canonical plan; bit-parity escape hatch)",
    )
    v.add_argument(
        "--no-verify-plans",
        action="store_true",
        help="tpu backend: skip the analysis plane's plan/IR invariant "
        "verifier after lowering, relocation and artifact load "
        "(advisory escape hatch)",
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
        pack_rules=not args.no_pack,
        plan_cache=not args.no_plan_cache,
        verify_plans=not args.no_verify_plans,
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
