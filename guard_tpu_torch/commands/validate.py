"""The `validate` command of the port.

The port of the JAX package's `validate` (guard_tpu/commands/validate.py):
walks rule and data paths (or a stdin JSON payload `{rules, data}`),
merges `--input-params` documents into each data file, and evaluates
every (rules file x data file) pair on one of four backends, the JAX
package's names:

* `tpu` (the port's default): the device path, `ops/backend.tpu_validate`
  on the CUDA card (or the device `--device` names) — full reports in
  every output format, or rule-level statuses under `--statuses-only`;
  unchanged documents replay from the result cache unless
  `--no-result-cache`;
* `cpu`: the CPU evaluator (core/evaluator.py), one pair at a time;
* `native`: the native C++ oracle (ops/native_oracle.py, built on first
  use), falling back to the CPU evaluator for each pair it declines;
* `auto`: `native` when the oracle is built, else `cpu`.

`cpu`, `native` and `auto` run no torch operation and need no card;
they alone print the verbose record tree (`-v`) and the record JSON
(`-p`), as in the JAX package. Exit codes follow the reference: 0 pass,
19 fail, 5 error (a rule file that does not parse, a document that does
not load, an evaluation that raised, an argument conflict).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.errors import GuardError, ParseError
from ..core.evaluator import eval_rules_file
from ..core.loader import load_document, load_payload
from ..core.parser import parse_rules_file
from ..core.qresult import Status
from ..core.scopes import RootScope
from ..core.values import PV
from ..utils.io import Reader, Writer
from ..utils.telemetry import span as _span
from .files import DATA_FILE_EXTENSIONS, RULE_FILE_EXTENSIONS, gather
from .report import rule_statuses_from_root, serde_record_json, simplified_report_from_root

SUCCESS_STATUS_CODE = 0
FAILURE_STATUS_CODE = 19
ERROR_STATUS_CODE = 5

OUTPUT_FORMATS = ("single-line-summary", "json", "yaml", "junit", "sarif")
SHOW_SUMMARY_TYPES = ("all", "pass", "fail", "skip", "none")

BACKENDS = ("auto", "cpu", "native", "tpu")


def _looks_json(content: str) -> bool:
    """First non-space byte sniff without copying the document."""
    for ch in content[:256]:
        if ch in " \t\r\n":
            continue
        return ch in "{["
    return False


def resolve_backend(backend: str) -> str:
    """`auto` picks the native oracle when its library is already
    built, the CPU evaluator otherwise (auto never triggers a compile;
    an explicit `native` does, through ensure_native_built)."""
    if backend != "auto":
        return backend
    from ..ops.native_oracle import native_available

    return "native" if native_available() else "cpu"


def ensure_native_built() -> Optional[str]:
    """None when the native oracle is usable (built on first use if
    need be); the JAX package's error message otherwise."""
    from ..ops.native_oracle import build_native, native_available

    if not native_available():
        try:
            build_native()
        except RuntimeError:
            pass
    if native_available():
        return None
    return (
        "native backend requested but the compiled engine is not built "
        "and could not be compiled (native/build_oracle.sh needs a C++ "
        "toolchain); use --backend cpu"
    )


@dataclass
class DataFile:
    """One data document. Its tree may build on first access (the tpu
    backend, and JSON under the native backend): the native encoder and
    the native oracle work from raw content, so the tree is built only
    when something walks it; parse errors surface there, before any
    evaluation output."""

    name: str
    content: str
    _pv: Optional[PV] = None
    # native backend: content validated as JSON (raw fast path ok)
    _raw_ok: bool = False

    @property
    def path_value(self) -> PV:
        if self._pv is None:
            self._pv = load_document(self.content, self.name)
        return self._pv

    @path_value.setter
    def path_value(self, value: PV) -> None:
        self._pv = value


@dataclass
class RuleFile:
    name: str
    full_name: str
    content: str
    rules: object  # RulesFile


@dataclass
class Validate:
    rules: List[str] = field(default_factory=list)
    data: List[str] = field(default_factory=list)
    input_params: List[str] = field(default_factory=list)
    output_format: str = "single-line-summary"
    show_summary: List[str] = field(default_factory=lambda: ["fail"])
    alphabetical: bool = False
    last_modified: bool = False
    # the verbose record tree and the record JSON, printed by the
    # backends off the device; on the device path they only turn the
    # native oracle off, as in the JAX package
    verbose: bool = False
    print_json: bool = False
    payload: bool = False
    structured: bool = False
    # auto | cpu | native | tpu (BACKENDS); tpu is the device path
    backend: str = "tpu"
    # tpu backend: failing documents report rule-level statuses without
    # per-clause detail: no oracle rerun for a device FAIL
    statuses_only: bool = False
    # tpu backend: ingest worker processes for the document encode
    # (parallel/ingest.py). None = auto (GUARD_TPU_INGEST_WORKERS, else
    # cpu_count - 1 capped at 4); 0 or 1 = encode in this process
    ingest_workers: Optional[int] = None
    # tpu backend: the document quarantine. None = a document that does
    # not load stops the run; N = such documents are skipped with a
    # message and left out of every report, and the run exits 5 only
    # when more than N were (a negative N allows any number)
    max_doc_failures: Optional[int] = None
    # tpu backend: fuse the rule files that can share one program into
    # packs (--no-pack turns it off)
    pack_rules: bool = True
    # tpu backend: the plan layer (ops/plan.py; --no-plan-cache turns it
    # off)
    plan_cache: bool = True
    # tpu backend: the plan/IR verifier (analysis/verify.py;
    # --no-verify-plans turns it off)
    verify_plans: bool = True
    # tpu backend: the vector rim (K3 on the device, mask arithmetic in
    # pass A, documents settled from shared templates); --no-vector-rim
    # launches no K3 and walks every (document, rule) status
    vector_rim: bool = True
    # tpu backend: the (doc shards x pack columns) mesh, --mesh-shape
    # (parallel/mesh2d.py); None = auto. One card runs every shape
    # unsharded
    mesh_shape: Optional[str] = None
    # tpu backend: the result cache (cache/results.py): unchanged
    # documents replay, only the delta is encoded and dispatched;
    # --no-result-cache turns it off
    result_cache: bool = True
    # tpu backend: print the cache's partition (cached against
    # dispatched documents) on stderr after the run
    delta_stats: bool = False
    # None = CUDA (raises without a card); "cpu" runs the plain kernels
    device: Optional[str] = None
    # data files loaded by an earlier run, reused in place of `data`
    # (their trees are built once for all runs over them)
    prepared_data: Optional[List[DataFile]] = None
    # serve sessions: the payload's rule files, parsed once by the
    # session (commands/serve.py) and reused across its requests
    prepared_rules: Optional[List[RuleFile]] = None
    # the Evaluation of the last execute (ops/backend.Evaluation)
    last_evaluation: object = None

    # -- argument validation (validate.rs:205-232) --------------------
    def _validate_args(self) -> None:
        show = set(self.show_summary)
        if self.structured and show != {"none"} and show != set():
            raise GuardError(
                "Cannot provide a summary-type other than `none` when the "
                "`structured` flag is present"
            )
        if self.structured and self.output_format == "single-line-summary":
            raise GuardError(
                "single-line-summary is not able to be used when the "
                "`structured` flag is present"
            )
        if self.output_format == "junit" and not self.structured:
            raise GuardError("the structured flag must be set when output is set to junit")
        if self.output_format == "sarif" and not self.structured:
            raise GuardError("the structured flag must be set when output is set to sarif")
        if self.payload and (self.rules or self.data):
            raise GuardError("cannot specify rules or data with payload")
        if not self.payload and not self.rules:
            raise GuardError("must specify rules or payload")
        if self.alphabetical and self.last_modified:
            raise GuardError("alphabetical conflicts with last-modified")
        if self.statuses_only:
            if self.backend != "tpu":
                raise GuardError("statuses-only requires the tpu backend")
            if (
                self.structured
                or self.verbose
                or self.print_json
                or self.output_format != "single-line-summary"
            ):
                raise GuardError(
                    "statuses-only conflicts with structured/verbose/"
                    "print-json and non-default output formats"
                )

    # -- input loading ------------------------------------------------
    def _load_data_files(self, reader: Reader) -> List[DataFile]:
        with _span("read_parse"):
            return self._load_data_files_inner(reader)

    def _load_data_files_inner(self, reader: Reader) -> List[DataFile]:
        if self.prepared_data is not None:
            return list(self.prepared_data)
        if self.data:
            data_files = []
            for f in gather(self.data, DATA_FILE_EXTENSIONS, self.last_modified):
                content = f.read_text()
                # lazy trees on the tpu backend, and for JSON on the
                # native one (its oracle parses raw JSON itself)
                lazy = self.backend == "tpu" or (
                    self.backend == "native" and _looks_json(content)
                )
                data_files.append(DataFile(
                    name=f.name, content=content,
                    _pv=None if lazy else load_document(content, f.name),
                ))
            return data_files
        content = reader.read()
        return [DataFile(name="STDIN", content=content, _pv=load_document(content))]

    def _load_rule_files(self, writer: Writer):
        rule_files: List[RuleFile] = []
        errors = 0
        sources = [
            (f.name, f.read_text(), str(f))
            for f in gather(self.rules, RULE_FILE_EXTENSIONS, self.last_modified)
        ]
        with _span("rule_parse", {"files": len(sources)}):
            for name, content, full in sources:
                try:
                    rf = parse_rules_file(content, name)
                except ParseError as e:
                    # per-file error isolation (validate.rs:406-434)
                    writer.writeln_err(f"Parse Error on ruleset file {name}")
                    writer.writeln_err(str(e))
                    errors += 1
                    continue
                if rf is not None:
                    rule_files.append(
                        RuleFile(name=name, full_name=full, content=content, rules=rf)
                    )
        return rule_files, errors

    def _merged_input_params(self) -> Optional[PV]:
        if not self.input_params:
            return None
        merged: Optional[PV] = None
        for f in gather(self.input_params, DATA_FILE_EXTENSIONS, self.last_modified):
            doc = load_document(f.read_text(), f.name)
            merged = doc if merged is None else merged.merge(doc)
        return merged

    # -- native oracle (--backend native) -----------------------------
    def _native_for(self, rule_file):
        """The native oracle's handle for one rules file, or None when
        it declines the file (the CPU evaluator runs every pair)."""
        from ..ops.native_oracle import NativeOracle, NativeUnsupported

        try:
            return NativeOracle(rule_file.rules)
        except NativeUnsupported:
            return None

    def _native_pair(self, native, data_file):
        """One (rules file, document) evaluation on the native oracle:
        (status, rule_statuses, report, root_record-or-None), or None
        when it declines this document (the CPU evaluator runs it).
        ParseError (a lazy document failing to load) propagates."""
        from ..ops.native_oracle import NativeEvalError, NativeUnsupported

        try:
            if self.verbose or self.print_json:
                # the verbose tree and the record JSON need the full
                # record tree, which the oracle builds as the CPU
                # evaluator does
                root = native.eval_records(data_file.path_value, data_file.name)
                report = simplified_report_from_root(root, data_file.name)
                return (
                    root.container.payload.status,
                    rule_statuses_from_root(root),
                    report,
                    root,
                )
            # documents loaded eagerly (not validated as JSON) whose raw
            # attempt failed once — e.g. flow-style YAML — would fail
            # the raw parse again for every rules file: skip raw after
            # the first failure. JSON-validated (_raw_ok) documents keep
            # retrying: their raw failures are rule-specific declines
            # or evaluation errors, not parse failures.
            sniff_raw = (
                data_file._pv is not None
                and not getattr(data_file, "_raw_sniff_failed", False)
                and _looks_json(data_file.content)
            )
            raw_ok = not self.input_params and (data_file._raw_ok or sniff_raw)
            if raw_ok:
                try:
                    report, statuses, status = native.eval_report_raw(
                        data_file.content, data_file.name
                    )
                    return status, statuses, report, None
                except (NativeUnsupported, NativeEvalError):
                    # flow-style YAML sniffing as JSON, or a decline:
                    # the loaded tree is authoritative. Only a genuine
                    # parse failure turns raw off for later rules files
                    if not data_file._raw_ok:
                        try:
                            json.loads(data_file.content)
                        except ValueError:
                            data_file._raw_sniff_failed = True
                        else:
                            data_file._raw_ok = True
            report, statuses, status = native.eval_report(
                data_file.path_value, data_file.name
            )
            return status, statuses, report, None
        except (NativeUnsupported, NativeEvalError):
            # declined, or an evaluation error: the CPU evaluator
            # reproduces a genuine error with its exact message
            return None

    # -- execution ----------------------------------------------------
    def execute(self, writer: Writer, reader: Reader) -> int:
        if self.backend not in BACKENDS:
            raise GuardError(
                f"unknown backend `{self.backend}` (choose from "
                f"{', '.join(BACKENDS)})"
            )
        # argument conflicts report before any (slow) native build
        self._validate_args()
        self.backend = resolve_backend(self.backend)
        if self.backend == "native":
            err = ensure_native_built()
            if err:
                raise GuardError(err)

        if self.payload:
            rule_files, data_files, errors = payload_inputs(
                reader.read(), writer, self.prepared_rules
            )
        else:
            try:
                data_files = self._load_data_files(reader)
                rule_files, errors = self._load_rule_files(writer)
            except FileNotFoundError as e:
                writer.writeln_err(_missing_file_message(e))
                return ERROR_STATUS_CODE
            except (GuardError, OSError) as e:
                writer.writeln_err(str(e))
                return ERROR_STATUS_CODE

        try:
            input_params = self._merged_input_params()
        except FileNotFoundError as e:
            writer.writeln_err(_missing_file_message(e))
            return ERROR_STATUS_CODE
        except (GuardError, OSError) as e:
            writer.writeln_err(str(e))
            return ERROR_STATUS_CODE

        if input_params is not None:
            try:
                for df in data_files:
                    df.path_value = _clone_pv(input_params).merge(df.path_value)
            except (GuardError, OSError) as e:
                # lazily built trees surface parse errors here with the
                # same message and exit code as eager loads
                writer.writeln_err(str(e))
                return ERROR_STATUS_CODE

        if self.backend == "native":
            # up-front validation of lazily loaded documents: one that
            # parses neither as JSON nor as YAML errors before any
            # evaluation output, as the eager loader does. Valid JSON
            # earns the raw path into the oracle; flow-style YAML that
            # is not JSON evaluates from its tree.
            try:
                for df in data_files:
                    if df._pv is None:
                        try:
                            json.loads(df.content)
                        except ValueError:
                            df.path_value  # loads or raises ParseError
                        else:
                            df._raw_ok = True
            except (GuardError, OSError) as e:
                writer.writeln_err(str(e))
                return ERROR_STATUS_CODE

        if self.backend == "tpu":
            from ..ops.backend import tpu_validate

            try:
                return tpu_validate(self, rule_files, data_files, writer)
            except GuardError as e:
                # document parse errors, and a device status that
                # disagrees with the oracle's
                writer.writeln_err(str(e))
                return ERROR_STATUS_CODE
        return self._evaluate_pairs(rule_files, data_files, errors, writer)

    def _evaluate_pairs(self, rule_files, data_files, errors: int, writer: Writer) -> int:
        """The backends off the device: every (rules file x data file)
        pair in turn on the native oracle or the CPU evaluator, with the
        console chain, the verbose tree and the record JSON per pair and
        the structured outputs at the end."""
        from .reporters.aware import console_chain
        from .reporters.console import print_verbose_tree
        from .reporters.junit import JunitTestCase, failure_info_from_report, write_junit
        from .reporters.sarif import write_sarif
        from .reporters.structured import write_structured

        had_fail = False
        all_reports: List[dict] = []
        # JUnit: one suite per data file, one case per rules file
        # (reporters/validate/xml.rs:22-61)
        junit_suites = {df.name: [] for df in data_files}

        use_native = self.backend == "native"
        for rule_file in rule_files:
            native = self._native_for(rule_file) if use_native else None
            for data_file in data_files:
                native_res = None
                if native is not None:
                    try:
                        native_res = self._native_pair(native, data_file)
                    except ParseError as e:
                        # lazily built JSON documents keep the eager
                        # loader's message and exit code
                        writer.writeln_err(str(e))
                        native.close()
                        return ERROR_STATUS_CODE
                if native_res is not None:
                    status, rule_statuses, report, root_record = native_res
                else:
                    try:
                        # built apart from the evaluation: a lazy
                        # document failing to load is fatal (the eager
                        # loader's contract), while evaluation errors
                        # below stay per pair
                        pv = data_file.path_value
                    except ParseError as e:
                        writer.writeln_err(str(e))
                        if native is not None:
                            native.close()
                        return ERROR_STATUS_CODE
                    try:
                        scope = RootScope(rule_file.rules, pv)
                        status = eval_rules_file(rule_file.rules, scope, data_file.name)
                    except GuardError as e:
                        writer.writeln_err(str(e))
                        errors += 1
                        junit_suites[data_file.name].append(
                            JunitTestCase(
                                name=rule_file.name, status=Status.FAIL, error=str(e)
                            )
                        )
                        continue
                    root_record = scope.reset_recorder().extract()
                    report = simplified_report_from_root(root_record, data_file.name)
                    rule_statuses = rule_statuses_from_root(root_record)
                all_reports.append(report)
                fname, fmsgs = failure_info_from_report(report)
                junit_suites[data_file.name].append(
                    JunitTestCase(
                        name=rule_file.name,
                        status=status,
                        failure_name=fname if status == Status.FAIL else None,
                        failure_messages=fmsgs if status == Status.FAIL else None,
                    )
                )
                if status == Status.FAIL:
                    had_fail = True

                if not self.structured:
                    console_chain(
                        writer, data_file.name, data_file.content,
                        data_file, rule_file.name,
                        status, rule_statuses, report, self.show_summary,
                        self.output_format,
                    )
                    if self.verbose:
                        print_verbose_tree(writer, root_record)
                    if self.print_json:
                        writer.writeln(
                            json.dumps(
                                serde_record_json(root_record),
                                indent=2,
                                ensure_ascii=False,
                            )
                        )
            if native is not None:
                native.close()

        if self.structured:
            if self.output_format in ("json", "yaml"):
                write_structured(writer, all_reports, self.output_format)
            elif self.output_format == "sarif":
                write_sarif(writer, all_reports)
            elif self.output_format == "junit":
                write_junit(writer, junit_suites)

        if errors > 0:
            return ERROR_STATUS_CODE
        if had_fail:
            return FAILURE_STATUS_CODE
        return SUCCESS_STATUS_CODE


def payload_inputs(payload_content, writer: Writer, prepared_rules=None):
    """`(rule_files, data_files, parse_errors)` from a payload document
    (`{"rules": [...], "data": [...]}`). Shared by Validate.execute and
    the serve batcher (serve/batcher.py), which must build a request's
    inputs as the sequential path does. `prepared_rules` are the rule
    files a serve session already parsed (all clean: a payload whose
    rules do not parse never has them, so its errors print here)."""
    rules_strs, data_strs = load_payload(payload_content)
    data_files = [
        DataFile(
            name=f"DATA_STDIN[{i + 1}]",
            content=d if isinstance(d, str) else json.dumps(d),
            _pv=load_document(d if isinstance(d, str) else json.dumps(d)),
        )
        for i, d in enumerate(data_strs)
    ]
    if prepared_rules is not None:
        return list(prepared_rules), data_files, 0
    rule_files = []
    errors = 0
    for i, content in enumerate(rules_strs):
        name = f"RULES_STDIN[{i + 1}]"
        try:
            rf = parse_rules_file(content, name)
        except ParseError as e:
            writer.writeln_err(f"Parse Error on ruleset file {name}")
            writer.writeln_err(str(e))
            errors += 1
            continue
        if rf is not None:
            rule_files.append(
                RuleFile(name=name, full_name=name, content=content, rules=rf)
            )
    return rule_files, data_files, errors


def _missing_file_message(e: FileNotFoundError) -> str:
    """The same wording whether the error came from walking the paths
    (the argument is the bare path) or from an OS call."""
    path = e.filename if e.filename is not None else str(e)
    return f"The path `{path}` does not exist"


def _clone_pv(pv: PV) -> PV:
    import copy

    return copy.deepcopy(pv)
