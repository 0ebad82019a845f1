"""`guard-tpu lint` — static analysis over Guard rule files.

Runs the analysis plane's rule linter (analysis/lint.py) over a set of
rule files/directories and reports structured findings, without
reading a single data document.

Exit-code contract (documented in docs/TPU_BACKEND.md and pinned by
bench.py --lint-smoke):

    0   no finding at or above the --fail-on threshold
        (default threshold: error)
    19  >= 1 finding at or above the threshold — the same "the rules
        are the problem" code `validate` uses for FAIL
    5   a rule file failed to parse or read (usage/IO error), taking
        precedence over 19

Output: one `file:line:col: SEVERITY [check] message` line per finding
on stdout (humans, grep, editors), or one JSON document with
`findings` + `summary` under `--structured` (CI, dashboards). The
summary totals always go to stderr so stdout stays machine-parseable.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Tuple

from ..analysis.lint import SEVERITIES, Finding, lint_files
from ..core.errors import GuardError, ParseError
from ..core.exprs import RulesFile
from ..core.parser import parse_rules_file
from ..utils.io import Reader, Writer
from .files import RULE_FILE_EXTENSIONS, gather

#: --fail-on choices: the weakest severity that still fails the run
#: ("never" = always exit 0 unless a file failed to parse)
FAIL_ON_CHOICES = ("error", "warning", "info", "never")


@dataclass
class Lint:
    rules: List[str] = field(default_factory=list)
    structured: bool = False
    fail_on: str = "error"
    last_modified: bool = False

    def execute(self, writer: Writer, reader: Reader) -> int:
        if not self.rules:
            raise GuardError("must specify rules")
        if self.fail_on not in FAIL_ON_CHOICES:
            raise GuardError(
                f"--fail-on must be one of {', '.join(FAIL_ON_CHOICES)}"
            )
        parsed: List[Tuple[str, RulesFile]] = []
        parse_errors = 0
        for f in gather(self.rules, RULE_FILE_EXTENSIONS,
                        self.last_modified):
            try:
                rf = parse_rules_file(f.read_text(), f.name)
            except ParseError as e:
                # per-file isolation like validate: report, keep
                # linting the rest, exit 5 at the end
                writer.writeln_err(f"Parse Error on ruleset file {f.name}")
                writer.writeln_err(str(e))
                parse_errors += 1
                continue
            if rf is None:
                continue  # empty file: nothing to lint
            parsed.append((str(f), rf))

        findings = lint_files(parsed)
        counts = {sev: 0 for sev in SEVERITIES}
        for fi in findings:
            counts[fi.severity] += 1

        if self.structured:
            writer.writeln(json.dumps({
                "findings": [fi.to_json() for fi in findings],
                "summary": {
                    "files": len(parsed),
                    "parse_errors": parse_errors,
                    **{sev.lower(): n for sev, n in counts.items()},
                },
            }, indent=1))
        else:
            for fi in findings:
                writer.writeln(fi.render())
        writer.writeln_err(
            f"lint: {len(parsed)} file(s), "
            f"{counts['ERROR']} error(s), {counts['WARNING']} "
            f"warning(s), {counts['INFO']} info"
            + (f", {parse_errors} parse error(s)" if parse_errors else "")
        )

        if parse_errors:
            return 5
        if self._fails(counts):
            return 19
        return 0

    def _fails(self, counts: dict) -> bool:
        if self.fail_on == "never":
            return False
        threshold = {"error": ("ERROR",),
                     "warning": ("ERROR", "WARNING"),
                     "info": SEVERITIES}[self.fail_on]
        return any(counts[sev] for sev in threshold)


def lint_findings(paths: List[str]) -> List[Finding]:
    """Library face (tests, tools): lint rule files under `paths` and
    return the findings; parse failures raise."""
    parsed = []
    for f in gather(paths, RULE_FILE_EXTENSIONS, False):
        rf = parse_rules_file(f.read_text(), f.name)
        if rf is not None:
            parsed.append((str(f), rf))
    return lint_files(parsed)
