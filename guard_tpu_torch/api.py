"""Library API: `run_checks` and the builder surface.

The port of the JAX package's guard_tpu/api.py: cfn-guard's embedding
points.
  * `run_checks` / `validate_and_return_json`
    (`guard/src/lib.rs:11`,
    `guard/src/commands/helper.rs:25-87`) — one-shot validate returning
    a JSON string (or the verbose event tree when verbose=True); the
    surface that FFI, Lambda and fuzzers converge on.
  * `ValidateBuilder` / `TestBuilder` / `ParseTreeBuilder` /
    `RulegenBuilder` (`guard/src/lib.rs:28-495`) — programmatic command
    construction with the same conflict validation as the CLI.
    `ValidateBuilder` defaults to the `tpu` backend (the JAX package's
    to `cpu`), and it and `TestBuilder` take `.device(d)`: None runs on
    the CUDA card, "cpu" on the plain versions of the kernels.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from .commands.parse_tree import ParseTree
from .commands.report import (
    rule_statuses_from_root,
    serde_record_json,
    simplified_report_from_root,
)
from .commands.rulegen import Rulegen
from .commands.test import Test
from .commands.validate import Validate
from .core.errors import GuardError, ParseError
from .core.evaluator import eval_rules_file
from .core.loader import load_document
from .core.parser import parse_rules_file
from .core.scopes import RootScope
from .utils.io import Reader, Writer


def run_checks(data: str, rules: str, verbose: bool = False,
               data_file_name: str = "", rules_file_name: str = "") -> str:
    """validate_and_return_json (helper.rs:25-87): evaluate one rules
    string against one data string, return a JSON report string."""
    try:
        path_value = load_document(data, data_file_name)
    except ParseError as e:
        raise ParseError(
            f"Unable to process data in file {data_file_name}, Error {e},"
        )
    rules_file = parse_rules_file(rules, rules_file_name)
    if rules_file is None:
        return ""
    scope = RootScope(rules_file, path_value)
    eval_rules_file(rules_file, scope, data_file_name or None)
    root_record = scope.reset_recorder().extract()
    if verbose:
        return json.dumps(
            serde_record_json(root_record), indent=2, ensure_ascii=False
        )
    report = simplified_report_from_root(root_record, data_file_name)
    return json.dumps([report], indent=2, ensure_ascii=False)


class CommandBuilder:
    """lib.rs:28-30."""

    def try_build(self):
        raise NotImplementedError

    def try_build_and_execute(self, payload: Optional[str] = None):
        cmd = self.try_build()
        writer = Writer.buffered()
        reader = Reader.from_string(payload or "")
        code = cmd.execute(writer, reader)
        return code, writer.stripped(), writer.err_to_stripped()


@dataclass
class ValidateBuilder(CommandBuilder):
    """lib.rs:96-347 (incl. the wasm `tryBuildAndExecute` entry)."""

    _rules: List[str] = field(default_factory=list)
    _data: List[str] = field(default_factory=list)
    _input_params: List[str] = field(default_factory=list)
    _output_format: str = "single-line-summary"
    _show_summary: List[str] = field(default_factory=lambda: ["fail"])
    _alphabetical: bool = False
    _last_modified: bool = False
    _verbose: bool = False
    _print_json: bool = False
    _payload: bool = False
    _structured: bool = False
    _backend: str = "tpu"
    _statuses_only: bool = False
    _device: Optional[str] = None

    def rules(self, rules: List[str]):
        self._rules = rules
        return self

    def data(self, data: List[str]):
        self._data = data
        return self

    def input_params(self, p: List[str]):
        self._input_params = p
        return self

    def output_format(self, fmt: str):
        self._output_format = fmt
        return self

    def show_summary(self, s: List[str]):
        self._show_summary = s
        return self

    def alphabetical(self, v: bool = True):
        if v and self._last_modified:
            raise GuardError("alphabetical conflicts with last_modified")
        self._alphabetical = v
        return self

    def last_modified(self, v: bool = True):
        if v and self._alphabetical:
            raise GuardError("last_modified conflicts with alphabetical")
        self._last_modified = v
        return self

    def verbose(self, v: bool = True):
        self._verbose = v
        return self

    def print_json(self, v: bool = True):
        self._print_json = v
        return self

    def payload(self, v: bool = True):
        if v and (self._rules or self._data):
            raise GuardError("payload conflicts with rules/data")
        self._payload = v
        return self

    def structured(self, v: bool = True):
        self._structured = v
        return self

    def backend(self, b: str):
        self._backend = b
        return self

    def statuses_only(self, v: bool = True):
        self._statuses_only = v
        return self

    def device(self, d: Optional[str]):
        self._device = d
        return self

    def try_build(self) -> Validate:
        return Validate(
            rules=self._rules,
            data=self._data,
            input_params=self._input_params,
            output_format=self._output_format,
            show_summary=self._show_summary,
            alphabetical=self._alphabetical,
            last_modified=self._last_modified,
            verbose=self._verbose,
            print_json=self._print_json,
            payload=self._payload,
            structured=self._structured,
            backend=self._backend,
            statuses_only=self._statuses_only,
            device=self._device,
        )


@dataclass
class TestBuilder(CommandBuilder):
    """lib.rs:351-462."""

    _rules_file: Optional[str] = None
    _test_data: Optional[str] = None
    _directory: Optional[str] = None
    _alphabetical: bool = False
    _last_modified: bool = False
    _verbose: bool = False
    _output_format: str = "single-line-summary"
    _device: Optional[str] = None

    def rules_file(self, f: str):
        self._rules_file = f
        return self

    def test_data(self, f: str):
        self._test_data = f
        return self

    def directory(self, d: str):
        self._directory = d
        return self

    def alphabetical(self, v: bool = True):
        self._alphabetical = v
        return self

    def last_modified(self, v: bool = True):
        self._last_modified = v
        return self

    def verbose(self, v: bool = True):
        self._verbose = v
        return self

    def output_format(self, fmt: str):
        self._output_format = fmt
        return self

    def device(self, d: Optional[str]):
        self._device = d
        return self

    def try_build(self) -> Test:
        if self._directory and (self._rules_file or self._test_data):
            raise GuardError("directory conflicts with rules_file/test_data")
        return Test(
            rules=self._rules_file,
            test_data=self._test_data,
            directory=self._directory,
            alphabetical=self._alphabetical,
            last_modified=self._last_modified,
            verbose=self._verbose,
            output_format=self._output_format,
            device=self._device,
        )


@dataclass
class ParseTreeBuilder(CommandBuilder):
    """lib.rs:35-90."""

    _rules: Optional[str] = None
    _output: Optional[str] = None
    _print_json: bool = False
    _print_yaml: bool = False

    def rules(self, r: str):
        self._rules = r
        return self

    def output(self, o: str):
        self._output = o
        return self

    def print_json(self, v: bool = True):
        self._print_json = v
        return self

    def print_yaml(self, v: bool = True):
        self._print_yaml = v
        return self

    def try_build(self) -> ParseTree:
        return ParseTree(
            rules=self._rules,
            output=self._output,
            print_json=self._print_json,
            print_yaml=self._print_yaml,
        )


@dataclass
class RulegenBuilder(CommandBuilder):
    """lib.rs:464-495."""

    _template: Optional[str] = None
    _output: Optional[str] = None

    def template(self, t: str):
        self._template = t
        return self

    def output(self, o: str):
        self._output = o
        return self

    def try_build(self) -> Rulegen:
        if not self._template:
            raise GuardError("template is required")
        return Rulegen(template=self._template, output=self._output)
