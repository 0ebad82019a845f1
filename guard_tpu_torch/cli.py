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
    python -m guard_tpu_torch sweep -r RULES (-d DATA | --follow) \
        [-M MANIFEST] [-c CHUNK_SIZE] [--backend tpu|cpu] [--rule-shards N] \
        [-m] [--no-pack] [--no-vector-rim] [--ingest-workers N] \
        [--max-doc-failures N] [--no-plan-cache] [--mesh-shape RxC] \
        [--no-result-cache] [--delta-stats] [--no-verify-plans] \
        [--resume] [--no-journal] [--trace-out FILE] [--metrics-out FILE] \
        [--device cpu]
    python -m guard_tpu_torch report [--ledger FILE] [--baseline FILE] \
        [--efficiency] [--check METRIC [--tolerance F] [--window N]]
    python -m guard_tpu_torch gc [--max-bytes N] [--dry-run]
    python -m guard_tpu_torch serve (--stdio | --listen HOST:PORT) \
        [--no-coalesce] [--rules FILE ...] [--tenant ID] \
        [--trace-out FILE] [--metrics-out FILE] [--device cpu]
    python -m guard_tpu_torch parse-tree [-r RULES] [-o OUT] [-p] [-y]
    python -m guard_tpu_torch rulegen -t TEMPLATE [-o OUT]
    python -m guard_tpu_torch lint -r RULES [-z] \
        [--fail-on error|warning|info|never] [-m]
    python -m guard_tpu_torch completions [-s bash|zsh|fish]

Same flags, stdout, stderr and exit codes as `python -m guard_tpu.cli`
with the same flags and the same `--backend` (`validate` and `sweep`: 0
pass / 19 fail / 5 error, and 75 for a drained `sweep`; `test`: 0 / 7
failing expectations / 1 error; `report`: 0 / 19 regression / 5 unusable
ledger; `gc`: always 0; `serve`: 0, or 75 when drained;
`parse-tree` and `rulegen`: 0 / 5; `lint`: 0 / 19 findings at
`--fail-on` / 5 a parse error; `completions`: 0). The differences:

* the default backend of both commands is `tpu` here (the port's entry
  points run on the card), `auto` in the JAX package;
* no flag has an environment twin (the JAX package also reads
  GUARD_TPU_RESULT_CACHE, GUARD_TPU_VECTOR_RIM, GUARD_TPU_MESH,
  GUARD_TPU_PACK, GUARD_TPU_PLAN_CACHE and GUARD_TPU_ANALYSIS);
* `test --backend tpu` has no catch-all: a spec goes to the host oracle
  only for the reasons `commands/test.py` names, and a device or kernel
  error ends the run with code 1;
* `sweep` has no catch-all on the device path either: only a GuardError
  (an injected fault, a GUARD_TPU_DISPATCH_TIMEOUT) takes the packed
  plane's per-file ladder, and a kernel or CUDA error ends the run with
  code 5; a resumed sweep over ingest workers prints the uninterrupted
  run's `evaluated` (the JAX package drops the replayed chunks there);
  the journal's run key holds the port's source digest and the device
  census; and the sweep has no GUARD_TPU_SWEEP_JOURNAL,
  GUARD_TPU_SWEEP_RESUME or GUARD_TPU_CACHE_MAX_BYTES twin;
* a `serve` request's backend defaults to `tpu` (the JAX package's to
  `auto`), coalescing is read on the resolved backend, and `serve` has
  no GUARD_TPU_COALESCE twin of `--no-coalesce`; with no card and no
  `--device` a `tpu` request answers code 5 and the session goes on;
* the evaluators run over every visible card (`--device cuda:k` names
  one). With one visible card every `--mesh-shape` runs unsharded; the
  JAX package cuts doc shards on one device too. The port pads no
  document to a multiple of the cards (parallel/mesh.py);
* the completion scripts name this program and its `--device` flag.

On `tpu` the walk and the rim run on the device, and the reports of the
documents that need one are built on the host by the native oracle
when it is built (ops/native_oracle.build_native), else by the port's
CPU evaluator; it runs on the CUDA device unless `--device` names
another, and with no card and no `--device` it stops with code 5.
`cpu`, `native` and `auto` evaluate on the host and need no card. The
result cache is on by default (`--no-result-cache` turns it off), in
GUARD_TPU_RESULT_CACHE_DIR, else ~/.cache/guard_tpu_torch/results.

`--trace-out FILE` writes a Chrome trace_event profile of the run (one
lane per host stage: open it in Perfetto or chrome://tracing; the
port's own spans split each dispatch and collect into `columnarize`,
`h2d_copy`, `walk_enqueue` and `device_wait`, and cover a sweep with
`sweep`, `sweep_scan`, `ingest_wait`, `chunk_fold` and
`journal_close`, utils/telemetry.py) and
`--metrics-out FILE` a schema-versioned snapshot of every counter
group, gauge and stage histogram (tools/check_metrics_schema.py); both
are written in a `finally`, so a run that fails leaves them too. The
flight recorder (GUARD_TPU_FLIGHT_RECORDER, on unless 0) dumps the last
spans and a metrics snapshot into GUARD_TPU_FLIGHTREC_DIR (default
~/.cache/guard_tpu_torch/flightrec) when `validate` or `sweep` exits
with code 5, drains (75) or raises. With GUARD_TPU_LEDGER_DIR set, each
`validate` and `sweep` session appends one record to the run ledger
there (utils/ledger.py), which `report` reads.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import List, Optional

from .commands.test import TEST_ERROR_STATUS_CODE, TEST_FORMATS, Test
from .commands.validate import BACKENDS, ERROR_STATUS_CODE, OUTPUT_FORMATS, Validate
from . import __version__
from .core.errors import GuardError
from .utils.io import Reader, Writer

PROG = "guard-tpu-torch"


def _add_backend_flag(sp: argparse.ArgumentParser) -> None:
    sp.add_argument(
        "--backend",
        default="tpu",
        choices=list(BACKENDS),
        help="tpu (default) = the device path on the CUDA card; auto = "
        "compiled C++ engine when built, else pure-Python; native/cpu "
        "force one",
    )


def _add_device_flags(sp: argparse.ArgumentParser, backend: bool = True) -> None:
    if backend:
        _add_backend_flag(sp)
    sp.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; `cpu` runs the "
        "plain versions of the kernels)",
    )


def _add_telemetry_flags(sp: argparse.ArgumentParser) -> None:
    """The telemetry export face (utils/telemetry.py) of validate and
    sweep: either flag turns span tracing on for the run."""
    sp.add_argument(
        "--trace-out",
        default=None,
        metavar="FILE",
        help="write a Chrome trace_event JSON profile of this run "
        "(open in Perfetto or chrome://tracing): one lane per pipeline "
        "stage plus per-ingest-worker lanes; besides the JAX package's "
        "spans, columnarize, h2d_copy and walk_enqueue (dispatch lane) "
        "and device_wait (collect lane) under each dispatch and "
        "collect, and for sweep the root sweep with sweep_scan, "
        "chunk_fold and journal_close (main lane) and ingest_wait "
        "(ingest lane)",
    )
    sp.add_argument(
        "--metrics-out",
        default=None,
        metavar="FILE",
        help="write a schema-versioned JSON metrics snapshot (all "
        "counter groups, histograms and span roll-ups)",
    )


def _add_sweep_parser(sub) -> None:
    s = sub.add_parser(
        "sweep",
        help="Resumable batch evaluation over a large corpus: chunked "
        "evaluation on the card with a JSONL checkpoint manifest",
    )
    s.add_argument("--rules", "-r", nargs="*", default=[])
    s.add_argument("--data", "-d", nargs="*", default=[])
    s.add_argument("--manifest", "-M", default="sweep-manifest.jsonl")
    s.add_argument("--chunk-size", "-c", type=int, default=1024)
    s.add_argument(
        "--backend", default="tpu", choices=["cpu", "tpu"],
        help="tpu (default) = the device path on the CUDA card; cpu = "
        "the CPU evaluator",
    )
    s.add_argument(
        "--rule-shards",
        type=int,
        default=1,
        help="split the rule set across this many device groups (one "
        "card runs one group)",
    )
    s.add_argument("--last-modified", "-m", action="store_true")
    s.add_argument(
        "--no-pack",
        action="store_true",
        help="tpu backend: disable fused multi-rule-file dispatch "
        "(evaluate each rule file through its own walk)",
    )
    s.add_argument(
        "--no-vector-rim",
        action="store_true",
        help="tpu backend: no rim reduction on the device (scalar "
        "per-document chunk tallies)",
    )
    s.add_argument(
        "--ingest-workers",
        type=int,
        default=None,
        help="tpu backend: worker processes that read and encode the "
        "chunks ahead of the card (default auto; 0 = the serial double "
        "buffer; overrides GUARD_TPU_INGEST_WORKERS)",
    )
    s.add_argument(
        "--max-doc-failures",
        type=int,
        default=None,
        help="exit ERROR when more than this many documents were "
        "quarantined (failed read/parse/encode). Default: unlimited; "
        "0 fails the run on any quarantined document",
    )
    s.add_argument(
        "--no-plan-cache",
        action="store_true",
        help="tpu backend: disable the compiled-plan artifact layer "
        "(re-lower the rule registry per chunk instead of relocating "
        "into the canonical plan)",
    )
    s.add_argument(
        "--mesh-shape",
        default=None,
        metavar="RxC",
        help="tpu backend: (doc shards x pack columns) mesh shape, e.g. "
        "2x1; 'auto' (the default) picks 2x1 when >1 card is visible, "
        "'off' runs unsharded; one visible card runs every shape unsharded",
    )
    s.add_argument(
        "--no-result-cache",
        action="store_true",
        help="tpu backend: disable the result cache (encode and "
        "dispatch every document instead of replaying unchanged ones; "
        "the same bytes)",
    )
    s.add_argument(
        "--delta-stats",
        action="store_true",
        help="tpu backend: print the result cache's partition (cached "
        "against dispatched documents) to stderr after the run",
    )
    s.add_argument(
        "--no-verify-plans",
        action="store_true",
        help="tpu backend: skip the analysis plane's plan/IR invariant "
        "verifier after lowering, relocation and artifact load",
    )
    s.add_argument(
        "--follow",
        action="store_true",
        help="streaming CI mode: validate JSONL documents from stdin as "
        "they arrive (micro-batches against the precompiled plan, one "
        "result line per input line, summary and sweep exit code at "
        "EOF; GUARD_TPU_FOLLOW_WAIT_MS bounds the wait for peers)",
    )
    s.add_argument(
        "--resume",
        action="store_true",
        help="replay this run's chunk journal: completed chunks replay "
        "with no encode and no launch, the sweep continues from the "
        "first incomplete chunk, and stdout, stderr, manifest and exit "
        "code are an uninterrupted run's (a stale journal is a logged "
        "cold start)",
    )
    s.add_argument(
        "--no-journal",
        action="store_true",
        help="disable the per-run chunk journal (no checkpoints: a "
        "killed run cannot --resume)",
    )
    _add_telemetry_flags(s)
    _add_device_flags(s, backend=False)


def _add_ops_parsers(sub) -> None:
    rp = sub.add_parser(
        "report",
        help="Render and diff run-ledger records (needs "
        "GUARD_TPU_LEDGER_DIR or --ledger)",
    )
    rp.add_argument(
        "--ledger",
        default=None,
        metavar="FILE",
        help="ledger JSONL to read (default: "
        "$GUARD_TPU_LEDGER_DIR/ledger.jsonl)",
    )
    rp.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help="diff the newest record against the newest record of this "
        "committed baseline ledger instead of the previous record",
    )
    rp.add_argument(
        "--efficiency",
        action="store_true",
        help="render the newest record's hardware-efficiency metrics "
        "(pack occupancy, transfer bytes, result-cache hit rate)",
    )
    rp.add_argument(
        "--check",
        default=None,
        metavar="METRIC",
        help="min-of-N noise-band regression gate on this headline "
        "metric; exits 19 on a regression",
    )
    rp.add_argument("--tolerance", type=float, default=0.15)
    rp.add_argument(
        "--window",
        type=int,
        default=3,
        help="how many prior records form the noise band (best-of-N "
        "baseline)",
    )

    g = sub.add_parser(
        "gc",
        help="Store hygiene: size-capped LRU eviction over the plan "
        "cache, the result database and the sweep journal directory, "
        "plus orphan-tmp reaping; crash-safe and always exit 0",
    )
    g.add_argument(
        "--max-bytes",
        type=int,
        default=None,
        metavar="N",
        help="evict least-recently-written store entries until each "
        "store is under this many bytes (default 1 GiB; 0 = empty the "
        "stores)",
    )
    g.add_argument(
        "--dry-run",
        action="store_true",
        help="report what would be evicted/reaped without deleting "
        "anything",
    )


def _add_serve_parsers(sub) -> None:
    sv = sub.add_parser(
        "serve",
        help="Persistent validate session: newline-delimited JSON "
        "payload requests on stdin, one JSON response line each",
    )
    # the transport is chosen explicitly: --stdio for a piped session,
    # --listen for the threaded TCP/HTTP listener, or both
    sv.add_argument("--stdio", action="store_true")
    sv.add_argument(
        "--listen",
        default=None,
        metavar="HOST:PORT",
        help="serve the same protocol to TCP/HTTP clients (port 0 = "
        "OS-assigned, announced on stderr); shares the session's "
        "prepared-rules cache, plan memo and coalescing batcher "
        "across connections",
    )
    sv.add_argument(
        "--no-coalesce",
        action="store_true",
        help="disable cross-request batch coalescing: every request "
        "dispatches alone",
    )
    sv.add_argument(
        "--rules",
        "-r",
        nargs="*",
        default=None,
        metavar="FILE",
        help="rule files preloaded as the session registry for the "
        "POST /webhook face (without it the webhook answers allowed "
        "with a 'no rules configured' message)",
    )
    sv.add_argument(
        "--tenant",
        default=None,
        metavar="ID",
        help="connection-default tenant id for the front door's "
        "per-tenant admission quotas (requests may override via their "
        "\"tenant\" field or the X-Guard-Tenant header; also "
        "GUARD_TPU_TENANT_DEFAULT)",
    )
    _add_telemetry_flags(sv)
    _add_device_flags(sv, backend=False)


def _add_host_parsers(sub) -> None:
    """The commands that read rule files and touch no device: lint,
    parse-tree, rulegen and completions."""
    from .commands.lint import FAIL_ON_CHOICES

    li = sub.add_parser(
        "lint",
        help="Statically analyze Guard rule files: unsatisfiable "
        "conjunctions, type conflicts, dead `when` guards, shadowed "
        "and duplicate rules, unreferenced variables — no data files "
        "needed (exit 0 clean / 19 findings at --fail-on / 5 parse "
        "error)",
    )
    li.add_argument(
        "--rules",
        "-r",
        nargs="*",
        default=[],
        help="rule files or directories to lint (directories are "
        "walked for .guard/.ruleset files)",
    )
    li.add_argument(
        "--structured",
        "-z",
        action="store_true",
        help="emit machine-readable JSON ({findings: [...], summary: "
        "{...}}) on stdout instead of file:line:col text",
    )
    li.add_argument(
        "--fail-on",
        default="error",
        choices=list(FAIL_ON_CHOICES),
        help="weakest finding severity that makes lint exit 19 "
        "(default error; never = report only, always exit 0 unless a "
        "file fails to parse)",
    )
    li.add_argument("--last-modified", "-m", action="store_true")

    pt = sub.add_parser("parse-tree", help="Prints the parse tree for a rules file")
    pt.add_argument("--rules", "-r", default=None)
    pt.add_argument("--output", "-o", default=None)
    pt.add_argument("--print-json", "-p", action="store_true")
    pt.add_argument("--print-yaml", "-y", action="store_true")

    rg = sub.add_parser("rulegen", help="Autogenerate rules from a CFN template")
    rg.add_argument("--template", "-t", required=True)
    rg.add_argument("--output", "-o", default=None)

    c = sub.add_parser("completions", help="Generate shell completions")
    c.add_argument("--shell", "-s", default="bash", choices=["bash", "zsh", "fish"])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Guard policy-as-code validation on a CUDA device "
        "(PyTorch port of the guard-tpu batch engine).",
    )
    p.add_argument("--version", action="version", version=f"{PROG} {__version__}")
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
    _add_backend_flag(v)
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
        "'off' runs unsharded; one visible card runs every shape unsharded",
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
    _add_telemetry_flags(v)
    _add_device_flags(v, backend=False)

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
    # the JAX CLI's order, so completion scripts list the commands alike
    _add_sweep_parser(sub)
    _add_host_parsers(sub)
    _add_serve_parsers(sub)
    _add_ops_parsers(sub)
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
    t0 = time.perf_counter()
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
        _session_epilogue(args, rc, time.perf_counter() - t0)


def _session_epilogue(args, rc: Optional[int], dt: float) -> None:
    """Exit hooks of the commands that drive the engine (validate,
    sweep, serve): the flight recorder dumps on exit code 5, on an
    unhandled exception (rc None), on a drain (75) and after latched fault
    activity, and the run ledger (utils/ledger.py) appends one session
    record when GUARD_TPU_LEDGER_DIR is set. Both are best-effort and
    never change the exit code."""
    if args.command not in ("validate", "sweep", "serve"):
        return
    from .utils import telemetry

    try:
        telemetry.flightrec_on_exit(rc)
    except Exception:
        pass
    from .utils import ledger

    if not ledger.ledger_enabled():
        return
    # the fraction of eligible documents that reached the device (None
    # when the run never partitioned against the result cache)
    extra = None
    try:
        gauges = telemetry.REGISTRY.snapshot().get("gauges", {})
        total = gauges.get("result_cache.total_docs")
        if total:
            extra = {
                "delta_docs": gauges.get("result_cache.delta_docs"),
                "total_docs": total,
                "delta_fraction": gauges.get("result_cache.delta_docs", 0) / total,
            }
            # the registry is process-global: zero the gauges so a later
            # session that never partitions cannot inherit them
            telemetry.REGISTRY.set_gauge("result_cache.delta_docs", 0)
            telemetry.REGISTRY.set_gauge("result_cache.total_docs", 0)
    except Exception:
        extra = None
    # a resumed sweep's record names the run it resumed and the chunks
    # it replayed; a drained session (75) is marked as such
    try:
        from .utils import journal

        info = journal.pop_resume_info()
        if info:
            extra = {**(extra or {}), **info}
        if rc == journal.DRAIN_EXIT_CODE:
            extra = {**(extra or {}), "drained": True}
    except Exception:
        pass
    try:
        ledger.append_record(
            kind=args.command,
            headline={
                "metric": f"{args.command}_session_seconds",
                "value": dt,
                "unit": "seconds",
            },
            config=dict(sorted(vars(args).items())),
            exit_code=rc,
            extra=extra,
        )
    except Exception:
        pass


def _dispatch(args, writer: Writer, reader: Reader) -> int:
    if args.command in ("report", "gc", "serve", "parse-tree", "rulegen", "lint",
                        "completions"):
        return _dispatch_ops(args, writer, reader)
    if args.command == "sweep":
        from .commands.sweep import Sweep

        cmd = Sweep(
            rules=args.rules,
            data=args.data,
            manifest=args.manifest,
            chunk_size=args.chunk_size,
            backend=args.backend,
            rule_shards=args.rule_shards,
            last_modified=args.last_modified,
            pack_rules=not args.no_pack,
            vector_rim=not args.no_vector_rim,
            ingest_workers=args.ingest_workers,
            max_doc_failures=args.max_doc_failures,
            plan_cache=not args.no_plan_cache,
            result_cache=not args.no_result_cache,
            delta_stats=args.delta_stats,
            verify_plans=not args.no_verify_plans,
            follow=args.follow,
            journal=not args.no_journal,
            resume=args.resume,
            mesh_shape=args.mesh_shape,
            device=args.device,
        )
        try:
            return cmd.execute(writer, reader)
        except (GuardError, OSError, RuntimeError) as e:
            # argument errors, unreadable paths, and no CUDA device
            # without --device; a kernel that does not build or launch
            # and a CUDA error end the run here too
            writer.writeln_err(f"Error: {e}")
            return ERROR_STATUS_CODE
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


def _dispatch_ops(args, writer: Writer, reader: Reader) -> int:
    """`report` (the run ledger's diff, check and efficiency views),
    `gc` (store hygiene, always 0), `serve` and the host-only
    `parse-tree` and `rulegen`."""
    try:
        if args.command == "serve":
            return _dispatch_serve(args, writer, reader)
        if args.command == "parse-tree":
            from .commands.parse_tree import ParseTree

            return ParseTree(
                rules=args.rules,
                output=args.output,
                print_json=args.print_json,
                print_yaml=args.print_yaml,
            ).execute(writer, reader)
        if args.command == "lint":
            from .commands.lint import Lint

            return Lint(
                rules=args.rules,
                structured=args.structured,
                fail_on=args.fail_on,
                last_modified=args.last_modified,
            ).execute(writer, reader)
        if args.command == "completions":
            from .commands.completions import Completions

            return Completions(shell=args.shell).execute(writer, reader)
        if args.command == "rulegen":
            from .commands.rulegen import Rulegen

            return Rulegen(template=args.template, output=args.output).execute(writer, reader)
        if args.command == "gc":
            from .commands.gc import Gc

            return Gc(max_bytes=args.max_bytes, dry_run=args.dry_run).execute(writer, reader)
        from .commands.ops_report import OpsReport

        return OpsReport(
            ledger_file=args.ledger,
            baseline=args.baseline,
            efficiency=args.efficiency,
            check=args.check,
            tolerance=args.tolerance,
            window=args.window,
        ).execute(writer, reader)
    except (GuardError, OSError) as e:
        writer.writeln_err(f"Error: {e}")
        return ERROR_STATUS_CODE


def _dispatch_serve(args, writer: Writer, reader: Reader) -> int:
    """The `serve` session (commands/serve.py); a card whose kernels do
    not build ends it with code 5 before the first request."""
    if not args.stdio and not args.listen:
        writer.writeln_err("serve requires a transport: --stdio and/or --listen HOST:PORT")
        return ERROR_STATUS_CODE
    from .commands.serve import Serve

    try:
        return Serve(
            stdio=args.stdio,
            listen=args.listen,
            coalesce=not args.no_coalesce,
            rules=args.rules,
            default_tenant=args.tenant,
            device=args.device,
        ).execute(writer, reader)
    except RuntimeError as e:
        writer.writeln_err(f"Error: {e}")
        return ERROR_STATUS_CODE


def main() -> None:
    code = run()
    sys.stdout.flush()
    sys.exit(code)


if __name__ == "__main__":
    main()
