"""The `test` command of the port: the built-in unit-test runner for rules.

The port of guard_tpu/commands/test.py: YAML/JSON test-spec files with
per-rule PASS/FAIL/SKIP expectations, in single-file mode
(`--rules-file` + `--test-data`) or directory mode (`--dir`, pairing
`x.guard` with `dir/tests/x*.yaml` by prefix). Exit codes: 0 ok / 7
test failures / 1 error. The output is the JAX package's byte for byte
with the same `--backend`.

On `tpu` (the port's default) every spec input of a rules file is
evaluated in one batch on the visible cards (`_device_by_rules`:
parallel/mesh.ShardedBatchEvaluator.evaluate_bucketed, with the
function-variable precompute), and a spec goes to the host oracle only
when the device cannot answer it: host-fallback rules or no device
rules, an oversized document or exotic numbers, a function error or an
unsure bit, or a batch that fails to encode. The JAX package also hands every spec to
its oracle when anything else fails (a catch-all); the port does not:
a kernel that does not build or launch, or a CUDA error, ends the run
with code 1 (cli.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import yaml

from ..core.errors import GuardError, ParseError
from ..core.evaluator import eval_rules_file
from ..core.parser import get_rule_name, parse_rules_file
from ..core.qresult import Status
from ..core.records import RecordType
from ..core.scopes import RootScope
from ..core.values import from_plain
from ..utils.io import Reader, Writer
from .reporters.console import print_verbose_tree
from .reporters.junit import JunitTestCase, write_junit

TEST_SUCCESS_STATUS_CODE = 0  # commands/mod.rs:72
TEST_FAILURE_STATUS_CODE = 7  # commands/mod.rs:72
TEST_ERROR_STATUS_CODE = 1  # commands/mod.rs:73

TEST_FORMATS = ("single-line-summary", "json", "yaml", "junit")


@dataclass
class TestSpec:
    name: Optional[str]
    input: object
    expectations: Dict[str, str]


def _load_specs(path: Path) -> List[TestSpec]:
    content = path.read_text()
    from ..core.loader import yaml_load_with_intrinsics

    try:
        data = yaml_load_with_intrinsics(content)
    except yaml.YAMLError:
        try:
            data = json.loads(content)
        except json.JSONDecodeError as e:
            raise ParseError(f"Unable to process data in file {path}, Error {e},")
    if not isinstance(data, list):
        raise ParseError(f"Test file {path} must contain a list of test specs")
    specs = []
    for entry in data:
        if entry is None:
            continue
        specs.append(
            TestSpec(
                name=entry.get("name"),
                input=entry.get("input"),
                expectations=(entry.get("expectations", {}) or {}).get("rules", {}) or {},
            )
        )
    return specs


def _rule_statuses(root_record, rule_file_name: str) -> Dict[str, List[Status]]:
    """get_by_rules: group top-level RuleCheck records by (prefix-stripped)
    rule name."""
    out: Dict[str, List[Status]] = {}
    for each in root_record.children:
        c = each.container
        if c is not None and c.kind == RecordType.RULE_CHECK:
            name = get_rule_name(rule_file_name, c.payload.name)
            out.setdefault(name, []).append(c.payload.status)
    return out


@dataclass
class Test:
    rules: Optional[str] = None
    test_data: Optional[str] = None
    directory: Optional[str] = None
    alphabetical: bool = False
    last_modified: bool = False
    verbose: bool = False
    output_format: str = "single-line-summary"
    # tpu (the device path, the port's default) | cpu | native | auto
    backend: str = "tpu"
    # None = CUDA (raises without a card); "cpu" runs the plain kernels
    device: Optional[str] = None
    # specs answered by each route of the last execute: "device",
    # "native" (the native oracle) and "oracle" (the CPU evaluator)
    routes: Optional[Dict[str, int]] = None

    def execute(self, writer: Writer, reader: Reader) -> int:
        from .validate import ensure_native_built, resolve_backend

        if self.directory is not None and (self.rules or self.test_data):
            writer.writeln_err("directory conflicts with rules-file/test-data")
            return TEST_ERROR_STATUS_CODE
        if self.directory is None and not (self.rules and self.test_data):
            writer.writeln_err(
                "must specify either --dir or both --rules-file and --test-data"
            )
            return TEST_ERROR_STATUS_CODE
        self.backend = resolve_backend(self.backend)
        # verbose mode never touches the compiled engine (_run_specs
        # needs rich per-case record trees), so don't build/require it
        if self.backend == "native" and not self.verbose:
            err = ensure_native_built()
            if err:
                writer.writeln_err(err)
                return TEST_ERROR_STATUS_CODE

        if self.directory is not None:
            pairs = self._ordered_test_directory(Path(self.directory))
        else:
            pairs = [(Path(self.rules), [Path(self.test_data)])]

        exit_code = TEST_SUCCESS_STATUS_CODE
        self.routes = {"device": 0, "native": 0, "oracle": 0}
        junit_suites = {}
        structured_reports = []
        single_file_mode = self.directory is None
        for rules_path, test_files in pairs:
            console = self.output_format == "single-line-summary"
            if self.directory is not None and not test_files:
                if console:
                    writer.writeln(
                        f"Guard File {rules_path} did not have any tests "
                        "associated, skipping."
                    )
                    writer.writeln("---")
                continue
            try:
                rf = parse_rules_file(rules_path.read_text(), rules_path.name)
            except ParseError as e:
                writer.writeln_err(f"Error processing {e}")
                exit_code = TEST_ERROR_STATUS_CODE
                continue
            if rf is None:
                continue
            if self.directory is not None and console:
                writer.writeln(f"Testing Guard File {rules_path}")
            code, cases, reports = self._run_specs(writer, rf, rules_path.name, test_files)
            junit_suites[str(rules_path)] = cases
            structured_reports.append(
                {
                    "rule_file": self.rules if single_file_mode else str(rules_path),
                    "test_cases": reports,
                }
            )
            if code == TEST_ERROR_STATUS_CODE:
                exit_code = TEST_ERROR_STATUS_CODE
            elif code == TEST_FAILURE_STATUS_CODE and exit_code == TEST_SUCCESS_STATUS_CODE:
                exit_code = TEST_FAILURE_STATUS_CODE
            if self.directory is not None and console:
                writer.writeln("---")  # per-file separator (test.rs:279)

        if self.output_format in ("json", "yaml"):
            # single-file mode serializes the one report object; a
            # directory serializes the list (test/structured.rs:211+)
            out = structured_reports[0] if single_file_mode and structured_reports else structured_reports
            if self.output_format == "json":
                # serde to_writer_pretty emits no trailing newline
                writer.write(json.dumps(out, indent=2))
            else:
                writer.write(
                    yaml.safe_dump(
                        out, sort_keys=False, default_flow_style=False, width=2**31
                    )
                )
        elif self.output_format == "junit":
            write_junit(writer, junit_suites, name="cfn-guard test report")
        return exit_code

    # -- directory pairing (test.rs:486-570) --------------------------
    def _ordered_test_directory(self, base: Path) -> List[Tuple[Path, List[Path]]]:
        guard_files: List[Path] = []
        test_candidates: List[Path] = []
        for p in sorted(base.rglob("*")):
            if not p.is_file():
                continue
            if p.suffix in (".guard", ".ruleset"):
                guard_files.append(p)
            elif p.suffix in (".yaml", ".yml", ".json", ".jsn"):
                if p.parent.name == "tests":
                    test_candidates.append(p)
        pairs: List[Tuple[Path, List[Path]]] = []
        by_dir: Dict[str, List[Tuple[str, Path, List[Path]]]] = {}
        for g in guard_files:
            prefix = g.name[: -len(g.suffix)]
            by_dir.setdefault(str(g.parent), []).append((prefix, g, []))
        for t in test_candidates:
            grand = str(t.parent.parent)
            for prefix, g, tests in by_dir.get(grand, []):
                if t.name.startswith(prefix):
                    tests.append(t)
                    break
        for dir_entries in by_dir.values():
            for _prefix, g, tests in dir_entries:
                pairs.append((g, tests))
        pairs.sort(key=lambda pair: str(pair[0]))
        return pairs

    # -- spec execution (reporters/test/generic.rs:24-137) ------------
    def _device_by_rules(self, rf, rule_file_name: str, specs):
        """`--backend tpu`: one batched evaluation on the device over
        every spec input of this rules file (validate's contract:
        statuses from the device, rich output from the oracle).
        Returns one Optional[by_rules dict] per spec; None sends that
        spec to the oracle. The reasons, and no other: host-fallback
        rules or no device rule (every spec), a batch that fails to
        encode (GuardError / ValueError from the encoder: every spec),
        an oversized document or exotic numbers, a function error, an
        unsure bit (that spec). Any other error, a device or kernel
        error among them, propagates."""
        from ..ops.backend import STATUS
        from ..ops.encoder import encode_batch
        from ..ops.fnvars import precompute_fn_values, precomputable_fn_vars
        from ..ops.ir import compile_rules_file
        from ..parallel.mesh import ShardedBatchEvaluator

        # the tpu_validate contract: function-let precompute before the
        # encode, bucketed evaluation with oversized documents left to
        # the host, unsure bits to the oracle
        fn_err = set()
        try:
            docs = [from_plain(spec.input) for spec in specs]
            if precomputable_fn_vars(rf):
                fn_vars, fn_vals, fn_err = precompute_fn_values(rf, docs)
                batch, interner = encode_batch(
                    docs, fn_values=fn_vals, fn_var_order=fn_vars
                )
            else:
                batch, interner = encode_batch(docs)
        except (GuardError, ValueError):
            return [None] * len(specs)
        compiled = compile_rules_file(rf, interner)
        if compiled.host_rules or not compiled.rules:
            return [None] * len(specs)
        evaluator = ShardedBatchEvaluator(compiled, device=self.device)
        statuses, unsure, host_docs, _rim = evaluator.evaluate_bucketed(batch)
        out = []
        for di in range(len(specs)):
            if (
                di in fn_err
                or di in host_docs
                or bool(batch.num_exotic[di])
                or (unsure is not None and bool(unsure[di].any()))
            ):
                out.append(None)
                continue
            by_rules: Dict[str, List[Status]] = {}
            for ri, crule in enumerate(compiled.rules):
                name = get_rule_name(rule_file_name, crule.name)
                by_rules.setdefault(name, []).append(
                    STATUS[int(statuses[di, ri])]
                )
            out.append(by_rules)
        return out

    def _native_by_rules(self, native, rf, rule_file_name: str, spec):
        """`--backend native`: per-rule status lists from the compiled
        engine (same grouping as _rule_statuses over the record tree —
        one top-level RuleCheck per guard rule, file order). None routes
        the spec to the Python oracle (engine declined)."""
        from ..ops.native_oracle import NativeEvalError, NativeUnsupported

        try:
            raw = native.eval_doc(from_plain(spec.input))
        except (NativeUnsupported, NativeEvalError, GuardError):
            return None
        st = {0: Status.PASS, 1: Status.FAIL, 2: Status.SKIP}
        out: Dict[str, List[Status]] = {}
        for rule, s in zip(rf.guard_rules, raw):
            name = get_rule_name(rule_file_name, rule.rule_name)
            out.setdefault(name, []).append(st[s])
        return out

    def _run_specs(self, writer: Writer, rf, rule_file_name: str, test_files):
        exit_code = TEST_SUCCESS_STATUS_CODE
        counter = 1
        cases: List[JunitTestCase] = []
        reports: List[dict] = []
        native = None
        if self.backend == "native" and not self.verbose:
            from ..ops.native_oracle import NativeOracle, NativeUnsupported

            try:
                native = NativeOracle(rf)
            except NativeUnsupported:
                native = None
        for tf in test_files:
            try:
                specs = _load_specs(tf)
            except ParseError as e:
                writer.writeln(f"Error processing {e}")
                exit_code = TEST_ERROR_STATUS_CODE
                continue
            device_results = None
            if self.backend == "tpu" and not self.verbose:
                device_results = self._device_by_rules(rf, rule_file_name, specs)
            for spec_idx, spec in enumerate(specs):
                if self.output_format == "single-line-summary":
                    writer.writeln(f"Test Case #{counter}")
                    if spec.name:
                        writer.writeln(f"Name: {spec.name}")
                by_rules = None
                route = "device"
                if device_results is not None:
                    by_rules = device_results[spec_idx]
                if by_rules is None and native is not None:
                    route = "native"
                    by_rules = self._native_by_rules(
                        native, rf, rule_file_name, spec
                    )
                if by_rules is None:
                    route = "oracle"
                    try:
                        root = from_plain(spec.input)
                        scope = RootScope(rf, root)
                        eval_rules_file(rf, scope, None)
                    except GuardError as e:
                        writer.writeln(f"Error processing {e}")
                        exit_code = TEST_ERROR_STATUS_CODE
                        counter += 1
                        continue
                    top = scope.reset_recorder().extract()
                    if self.verbose and self.output_format == "single-line-summary":
                        # the reference prints the event tree right
                        # after the case header, before the expectation
                        # lines (test.rs verbose path)
                        print_verbose_tree(writer, top)
                    by_rules = _rule_statuses(top, rule_file_name)
                self.routes[route] += 1
                passed_lines: List[str] = []
                failed_lines: List[str] = []
                spec_report = {
                    "name": spec.name or "",
                    "passed_rules": [],
                    "failed_rules": [],
                    "skipped_rules": [],
                }
                for rule_name, statuses in by_rules.items():
                    expected = spec.expectations.get(rule_name)
                    if expected is None:
                        if self.output_format == "single-line-summary":
                            writer.writeln(
                                f"  No Test expectation was set for Rule {rule_name}"
                            )
                        else:
                            spec_report["skipped_rules"].append({"name": rule_name})
                        continue
                    matched = next(
                        (s for s in statuses if s.value == expected), None
                    )
                    if matched is not None:
                        passed_lines.append(f"{rule_name}: Expected = {expected}")
                        cases.append(
                            JunitTestCase(
                                name=rule_name,
                                status=Status.PASS,
                                id=spec.name or "",
                            )
                        )
                        spec_report["passed_rules"].append(
                            {"name": rule_name, "evaluated": matched.value}
                        )
                    else:
                        failed_lines.append(
                            f"{rule_name}: Expected = {expected}, Evaluated = "
                            f"{[s.value for s in statuses]}"
                        )
                        cases.append(
                            JunitTestCase(
                                name=rule_name,
                                status=Status.FAIL,
                                id=spec.name or "",
                                failure_messages=[
                                    f"Expected = {expected}, Evaluated = "
                                    f"{[s.value for s in statuses]}"
                                ],
                            )
                        )
                        spec_report["failed_rules"].append(
                            {
                                "name": rule_name,
                                "expected": expected,
                                "evaluated": [s.value for s in statuses],
                            }
                        )
                        exit_code = max(exit_code, TEST_FAILURE_STATUS_CODE)
                if self.output_format == "single-line-summary":
                    if failed_lines:
                        writer.writeln("  FAIL Rules:")
                        for line in failed_lines:
                            writer.writeln(f"    {line}")
                    if passed_lines:
                        writer.writeln("  PASS Rules:")
                        for line in passed_lines:
                            writer.writeln(f"    {line}")
                    writer.writeln()
                reports.append(spec_report)
                counter += 1
        if native is not None:
            native.close()
        return exit_code, cases, reports
