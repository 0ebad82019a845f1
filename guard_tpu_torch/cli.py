"""Command-line interface of the torch port.

    python -m guard_tpu_torch validate -r RULES -d DATA \
        [-o single-line-summary|json|yaml|junit|sarif] [-z] \
        [-S fail,pass,...] [-i PARAMS] [-P] [-a|-m] [-t TYPE] [-v] [-p] \
        [--backend tpu|cpu|native|auto] [--statuses-only] [--no-pack] \
        [--no-vector-rim] [--ingest-workers N] [--max-doc-failures N] \
        [--no-plan-cache] [--mesh-shape RxC|auto|off] [--no-result-cache] \
        [--delta-stats] [--no-verify-plans] [--trace-out FILE] \
        [--metrics-out FILE] [--device cpu]
    python -m guard_tpu_torch test (-r RULES -t TESTS | -d DIR) \
        [-o single-line-summary|json|yaml|junit] [-a|-m] [-v] \
        [--backend tpu|cpu|native|auto] [--device cpu]

Same flags, stdout, stderr and exit codes as `python -m guard_tpu.cli`
with the same flags and the same `--backend` (`validate`: 0 pass / 19
fail / 5 error; `test`: 0 / 7 failing expectations / 1 error). The
differences:

* the default backend of both commands is `tpu` here (the port's entry
  points run on the card), `auto` in the JAX package;
* no flag has an environment twin (the JAX package also reads
  GUARD_TPU_RESULT_CACHE, GUARD_TPU_VECTOR_RIM, GUARD_TPU_MESH,
  GUARD_TPU_PACK, GUARD_TPU_PLAN_CACHE and GUARD_TPU_ANALYSIS);
* `test --backend tpu` has no catch-all: a spec goes to the host oracle
  only for the reasons `commands/test.py` names, and a device or kernel
  error ends the run with code 1.

On `tpu` the walk and the rim run on the device, and the reports of the
documents that need one are built on the host by the native oracle
when it is built (ops/native_oracle.build_native), else by the port's
CPU evaluator; it runs on the CUDA device unless `--device` names
another, and with no card and no `--device` it stops with code 5.
`cpu`, `native` and `auto` evaluate on the host and need no card. The
result cache is on by default (`--no-result-cache` turns it off), in
GUARD_TPU_RESULT_CACHE_DIR, else ~/.cache/guard_tpu_torch/results.

`--trace-out FILE` writes a Chrome trace_event profile of the run (one
lane per host stage: open it in Perfetto or chrome://tracing) and
`--metrics-out FILE` a schema-versioned snapshot of every counter
group, gauge and stage histogram (tools/check_metrics_schema.py); both
are written in a `finally`, so a run that fails leaves them too. The
flight recorder (GUARD_TPU_FLIGHT_RECORDER, on unless 0) dumps the last
spans and a metrics snapshot into GUARD_TPU_FLIGHTREC_DIR (default
~/.cache/guard_tpu_torch/flightrec) when `validate` exits with code 5 or
raises.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import List, Optional

from .commands.test import TEST_ERROR_STATUS_CODE, TEST_FORMATS, Test
from .commands.validate import BACKENDS, ERROR_STATUS_CODE, OUTPUT_FORMATS, Validate
from .core.errors import GuardError
from .utils.io import Reader, Writer

PROG = "guard-tpu-torch"


def _add_device_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument(
        "--backend",
        default="tpu",
        choices=list(BACKENDS),
        help="tpu (default) = the device path on the CUDA card; auto = "
        "compiled C++ engine when built, else pure-Python; native/cpu "
        "force one",
    )
    sp.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; `cpu` runs the "
        "plain versions of the kernels)",
    )


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
        "--no-vector-rim",
        action="store_true",
        help="tpu backend: no rim reduction on the device (a scalar "
        "walk over every document's statuses instead of mask "
        "arithmetic and shared report templates)",
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
        "--mesh-shape",
        default=None,
        metavar="RxC",
        help="tpu backend: (doc shards x pack columns) mesh shape, e.g. "
        "2x1; 'auto' (the default) picks 2x1 when >1 card is visible, "
        "'off' runs unsharded; one card runs every shape unsharded",
    )
    v.add_argument(
        "--no-result-cache",
        action="store_true",
        help="tpu backend: disable the result cache (encode and "
        "dispatch every document instead of replaying unchanged ones; "
        "the same bytes)",
    )
    v.add_argument(
        "--delta-stats",
        action="store_true",
        help="tpu backend: print the result cache's partition (cached "
        "against dispatched documents) to stderr after the run",
    )
    v.add_argument(
        "--no-verify-plans",
        action="store_true",
        help="tpu backend: skip the analysis plane's plan/IR invariant "
        "verifier after lowering, relocation and artifact load "
        "(advisory escape hatch)",
    )
    v.add_argument(
        "--trace-out",
        default=None,
        metavar="FILE",
        help="write a Chrome trace_event JSON profile of this run "
        "(open in Perfetto or chrome://tracing): one lane per pipeline "
        "stage plus per-ingest-worker lanes",
    )
    v.add_argument(
        "--metrics-out",
        default=None,
        metavar="FILE",
        help="write a schema-versioned JSON metrics snapshot (all "
        "counter groups, histograms and span roll-ups)",
    )
    _add_device_flags(v)

    t = sub.add_parser("test", help="Test rules against expectations")
    t.add_argument("--rules-file", "-r", dest="rules", default=None)
    t.add_argument("--test-data", "-t", dest="test_data", default=None)
    t.add_argument("--dir", "-d", dest="directory", default=None)
    t.add_argument("--alphabetical", "-a", action="store_true")
    t.add_argument("--last-modified", "-m", action="store_true")
    t.add_argument("--verbose", "-v", action="store_true")
    t.add_argument(
        "--output-format", "-o", default="single-line-summary", choices=TEST_FORMATS,
    )
    _add_device_flags(t)
    return p


@contextlib.contextmanager
def telemetry_export(trace_out: Optional[str], metrics_out: Optional[str]):
    """Span tracing for the body when either file is named, and the
    trace and the metrics snapshot written when the body ends, however
    it ends."""
    if not (trace_out or metrics_out):
        yield
        return
    from .utils import telemetry

    telemetry.enable()
    telemetry.reset_trace()
    try:
        yield
    finally:
        if trace_out:
            telemetry.write_trace(trace_out)
        if metrics_out:
            telemetry.write_metrics(metrics_out)
        telemetry.disable()


def run(argv: Optional[List[str]] = None, writer: Optional[Writer] = None,
        reader: Optional[Reader] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    writer = writer or Writer()
    reader = reader or Reader()
    if args.command is None:
        parser.print_help()
        return 0
    rc: Optional[int] = None
    try:
        with telemetry_export(getattr(args, "trace_out", None),
                              getattr(args, "metrics_out", None)):
            rc = _dispatch(args, writer, reader)
        return rc
    except BrokenPipeError:
        rc = 141
        raise
    finally:
        if args.command == "validate":
            _session_epilogue(rc)


def _session_epilogue(rc: Optional[int]) -> None:
    """The flight recorder's exit hook: it dumps on exit code 5, on an
    unhandled exception (rc None) and after latched fault activity. It
    never changes the exit code. (The JAX package's run ledger waits
    for the port's sweep.)"""
    from .utils import telemetry

    try:
        telemetry.flightrec_on_exit(rc)
    except Exception:
        pass


def _dispatch(args, writer: Writer, reader: Reader) -> int:
    if args.command == "test":
        cmd = Test(
            rules=args.rules,
            test_data=args.test_data,
            directory=args.directory,
            alphabetical=args.alphabetical,
            last_modified=args.last_modified,
            verbose=args.verbose,
            output_format=args.output_format,
            backend=args.backend,
            device=args.device,
        )
        try:
            return cmd.execute(writer, reader)
        except (GuardError, OSError) as e:
            # what the JAX CLI does with these for every command
            writer.writeln_err(f"Error: {e}")
            return ERROR_STATUS_CODE
        except (RuntimeError, ValueError) as e:
            # a kernel that does not build or launch, a CUDA error, no
            # card without --device: the run ends, nothing falls back
            writer.writeln_err(f"Error: {e}")
            return TEST_ERROR_STATUS_CODE
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
        vector_rim=not args.no_vector_rim,
        plan_cache=not args.no_plan_cache,
        mesh_shape=args.mesh_shape,
        result_cache=not args.no_result_cache,
        delta_stats=args.delta_stats,
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
