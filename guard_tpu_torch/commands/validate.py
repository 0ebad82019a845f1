"""The `validate` command of the port: statuses-only, on the device.

Reads rule and data files like the JAX package's `validate`
(guard_tpu/commands/validate.py) and evaluates them through
`ops/backend.validate_statuses`. Exit codes follow the reference: 0
pass, 19 fail, 5 error (a rule file that does not parse, a document
that does not load, an oracle rerun that raised).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..core.errors import GuardError, ParseError
from ..core.loader import load_document
from ..core.parser import parse_rules_file
from ..core.values import PV
from ..utils.io import Reader, Writer
from .files import DATA_FILE_EXTENSIONS, RULE_FILE_EXTENSIONS, gather

SUCCESS_STATUS_CODE = 0
FAILURE_STATUS_CODE = 19
ERROR_STATUS_CODE = 5

SHOW_SUMMARY_TYPES = ("all", "pass", "fail", "skip", "none")


@dataclass
class DataFile:
    """One data document; its tree builds on first access."""

    name: str
    content: str
    _pv: Optional[PV] = None

    @property
    def path_value(self) -> PV:
        if self._pv is None:
            self._pv = load_document(self.content, self.name)
        return self._pv


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
    show_summary: List[str] = field(default_factory=lambda: ["fail"])
    last_modified: bool = False
    # the only mode of this slice: failing documents report rule-level
    # statuses without per-clause detail
    statuses_only: bool = False
    # None = CUDA (raises without a card); "cpu" runs the plain kernels
    device: Optional[str] = None
    # the Evaluation of the last execute (ops/backend.Evaluation)
    last_evaluation: object = None

    def _validate_args(self) -> None:
        if not self.rules:
            raise GuardError("must specify rules or payload")
        if not self.statuses_only:
            raise GuardError(
                "the torch port evaluates --statuses-only runs only; full "
                "reports come with a later slice"
            )

    def _load_data_files(self, reader: Reader) -> List[DataFile]:
        if not self.data:
            return [DataFile(name="STDIN", content=reader.read())]
        return [
            DataFile(name=f.name, content=f.read_text())
            for f in gather(self.data, DATA_FILE_EXTENSIONS, self.last_modified)
        ]

    def _load_rule_files(self, writer: Writer) -> List[RuleFile]:
        rule_files: List[RuleFile] = []
        for f in gather(self.rules, RULE_FILE_EXTENSIONS, self.last_modified):
            content = f.read_text()
            try:
                rf = parse_rules_file(content, f.name)
            except ParseError as e:
                # per-file error isolation, as in the JAX package's
                # device path: the file is reported and skipped
                writer.writeln_err(f"Parse Error on ruleset file {f.name}")
                writer.writeln_err(str(e))
                continue
            if rf is not None:
                rule_files.append(
                    RuleFile(name=f.name, full_name=str(f), content=content, rules=rf)
                )
        return rule_files

    def execute(self, writer: Writer, reader: Reader) -> int:
        from ..ops.backend import validate_statuses

        self._validate_args()
        try:
            data_files = self._load_data_files(reader)
            rule_files = self._load_rule_files(writer)
        except FileNotFoundError as e:
            path = e.filename if e.filename is not None else str(e)
            writer.writeln_err(f"The path `{path}` does not exist")
            return ERROR_STATUS_CODE
        except (GuardError, OSError) as e:
            writer.writeln_err(str(e))
            return ERROR_STATUS_CODE
        try:
            return validate_statuses(self, rule_files, data_files, writer)
        except GuardError as e:
            # document parse errors, and a device status that disagrees
            # with the oracle's
            writer.writeln_err(str(e))
            return ERROR_STATUS_CODE
