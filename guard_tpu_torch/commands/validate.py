"""The `validate` command of the port, on the device.

The port of the JAX package's `validate --backend tpu`
(guard_tpu/commands/validate.py): walks rule and data paths (or a stdin
JSON payload `{rules, data}`), merges `--input-params` documents into
each data file, and evaluates every (rules file x data file) pair
through `ops/backend.tpu_validate`: full reports in every output format,
or rule-level statuses under `--statuses-only`. Exit codes follow the
reference: 0 pass, 19 fail, 5 error (a rule file that does not parse, a
document that does not load, an oracle rerun that raised, an argument
conflict).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.errors import GuardError, ParseError
from ..core.loader import load_document, load_payload
from ..core.parser import parse_rules_file
from ..core.values import PV
from ..utils.io import Reader, Writer
from .files import DATA_FILE_EXTENSIONS, RULE_FILE_EXTENSIONS, gather

SUCCESS_STATUS_CODE = 0
FAILURE_STATUS_CODE = 19
ERROR_STATUS_CODE = 5

OUTPUT_FORMATS = ("single-line-summary", "json", "yaml", "junit", "sarif")
SHOW_SUMMARY_TYPES = ("all", "pass", "fail", "skip", "none")


def _looks_json(content: str) -> bool:
    """First non-space byte sniff without copying the document."""
    for ch in content[:256]:
        if ch in " \t\r\n":
            continue
        return ch in "{["
    return False


@dataclass
class DataFile:
    """One data document; its tree builds on first access (parse errors
    surface there, before any evaluation output)."""

    name: str
    content: str
    _pv: Optional[PV] = None

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
    # accepted as in the JAX package; on the device path they only turn
    # the native oracle off (the verbose tree and the record JSON are
    # printed by the validate paths off the device, not ported yet)
    verbose: bool = False
    print_json: bool = False
    payload: bool = False
    structured: bool = False
    # failing documents report rule-level statuses without per-clause
    # detail: no oracle rerun for a device FAIL
    statuses_only: bool = False
    # None = CUDA (raises without a card); "cpu" runs the plain kernels
    device: Optional[str] = None
    # data files loaded by an earlier run, reused in place of `data`
    # (their trees are built once for all runs over them)
    prepared_data: Optional[List[DataFile]] = None
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
        if self.statuses_only and (
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
        if self.prepared_data is not None:
            return list(self.prepared_data)
        if self.data:
            # lazy trees: built by the backend before any evaluation
            return [
                DataFile(name=f.name, content=f.read_text())
                for f in gather(self.data, DATA_FILE_EXTENSIONS, self.last_modified)
            ]
        content = reader.read()
        return [DataFile(name="STDIN", content=content, _pv=load_document(content))]

    def _load_rule_files(self, writer: Writer):
        rule_files: List[RuleFile] = []
        errors = 0
        for f in gather(self.rules, RULE_FILE_EXTENSIONS, self.last_modified):
            content = f.read_text()
            try:
                rf = parse_rules_file(content, f.name)
            except ParseError as e:
                # per-file error isolation (validate.rs:406-434)
                writer.writeln_err(f"Parse Error on ruleset file {f.name}")
                writer.writeln_err(str(e))
                errors += 1
                continue
            if rf is not None:
                rule_files.append(
                    RuleFile(name=f.name, full_name=str(f), content=content, rules=rf)
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

    # -- execution ----------------------------------------------------
    def execute(self, writer: Writer, reader: Reader) -> int:
        from ..ops.backend import tpu_validate

        self._validate_args()
        if self.payload:
            # the device path reports rule-file parse errors on stderr
            # and goes on with the other files, as the JAX package does
            rule_files, data_files, _errors = payload_inputs(reader.read(), writer)
        else:
            try:
                data_files = self._load_data_files(reader)
                rule_files, _errors = self._load_rule_files(writer)
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

        try:
            return tpu_validate(self, rule_files, data_files, writer)
        except GuardError as e:
            # document parse errors, and a device status that disagrees
            # with the oracle's
            writer.writeln_err(str(e))
            return ERROR_STATUS_CODE


def payload_inputs(payload_content, writer: Writer):
    """`(rule_files, data_files, parse_errors)` from a payload document
    (`{"rules": [...], "data": [...]}`)."""
    rules_strs, data_strs = load_payload(payload_content)
    data_files = [
        DataFile(
            name=f"DATA_STDIN[{i + 1}]",
            content=d if isinstance(d, str) else json.dumps(d),
            _pv=load_document(d if isinstance(d, str) else json.dumps(d)),
        )
        for i, d in enumerate(data_strs)
    ]
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
