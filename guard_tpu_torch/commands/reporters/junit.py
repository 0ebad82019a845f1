"""JUnit XML output.

Byte-level equivalent of the reference's validate JUnit path
(`reporters/validate/xml.rs` + `reporters/mod.rs:106-340`, pinned by
`resources/validate/output-dir/structured.junit`): one <testsuite> per
data file with one <testcase> per rules file; a failing case carries a
single <failure> whose `message` attribute is the failing rule's short
name and whose text concatenates every failure message (custom then
error, in report order); non-failing cases self-close with a `status`
attribute. quick_xml details reproduced: 4-space indent, no space
before `/>` on empty tags, quotes escaped in text content."""

from __future__ import annotations

from typing import Dict, List, Optional

from ...core.qresult import Status
from ...utils.io import Writer


class JunitTestCase:
    """One (data file x rules file) evaluation."""

    def __init__(
        self,
        name: str,
        status: Status,
        failure_name: Optional[str] = None,
        failure_messages: Optional[List[str]] = None,
        error: Optional[str] = None,
        time_ms: int = 0,
        id: Optional[str] = None,
    ):
        self.id = id
        self.name = name
        self.status = status
        self.failure_name = failure_name
        self.failure_messages = failure_messages or []
        self.error = error
        self.time_ms = time_ms


def failure_info_from_report(report: dict):
    """(failing_rule_short_name, messages) from a FileReport dict —
    reporters/mod.rs:117-138: the fold keeps the LAST failing rule's
    name (stripped after ".guard/") and appends every leaf message's
    custom_message then error_message."""
    from .sarif import _rule_messages

    name = None
    messages: List[str] = []
    for failure in report.get("not_compliant", []):
        if "Rule" in failure:
            rule_name = failure["Rule"]["name"]
            if ".guard/" in rule_name:
                rule_name = rule_name.split(".guard/", 1)[1]
            name = rule_name
        for msgs in _rule_messages(failure):
            if msgs.get("custom_message"):
                messages.append(msgs["custom_message"])
            if msgs.get("error_message"):
                messages.append(msgs["error_message"])
    return name, messages


def _esc_attr(s: str) -> str:
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def _esc_text(s: str) -> str:
    # quick_xml escapes quotes in text content too
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        .replace('"', "&quot;").replace("'", "&apos;")
    )


def write_junit(
    writer: Writer,
    suites: Dict[str, List[JunitTestCase]],
    name: str = "cfn-guard validate report",
) -> None:
    total = sum(len(cases) for cases in suites.values())
    # Fail and Error are mutually exclusive (reference xml.rs:36-41)
    failures = sum(
        1
        for cases in suites.values()
        for c in cases
        if c.status == Status.FAIL and c.error is None
    )
    errors = sum(
        1 for cases in suites.values() for c in cases if c.error is not None
    )
    out: List[str] = ['<?xml version="1.0" encoding="UTF-8"?>']
    out.append(
        f'<testsuites name="{_esc_attr(name)}" tests="{total}" '
        f'failures="{failures}" errors="{errors}" time="0">'
    )
    for suite_name, cases in suites.items():
        s_failures = sum(
            1 for c in cases if c.status == Status.FAIL and c.error is None
        )
        s_errors = sum(1 for c in cases if c.error is not None)
        out.append(
            f'    <testsuite name="{_esc_attr(suite_name)}" '
            f'errors="{s_errors}" failures="{s_failures}" time="0">'
        )
        for case in cases:
            id_attr = f'id="{_esc_attr(case.id)}" ' if case.id is not None else ""
            base = f'{id_attr}name="{_esc_attr(case.name)}" time="{case.time_ms}"'
            if case.error is not None:
                out.append(f'        <testcase {base} status="error">')
                out.append(f"            <error>{_esc_text(case.error)}</error>")
                out.append("        </testcase>")
            elif case.status == Status.FAIL:
                out.append(f"        <testcase {base}>")
                msg_attr = (
                    f' message="{_esc_attr(case.failure_name)}"'
                    if case.failure_name
                    else ""
                )
                if case.failure_messages:
                    text = "".join(_esc_text(m) for m in case.failure_messages)
                    out.append(f"            <failure{msg_attr}>{text}</failure>")
                else:
                    out.append(f"            <failure{msg_attr}/>")
                out.append("        </testcase>")
            else:
                status = "pass" if case.status == Status.PASS else "skip"
                out.append(f'        <testcase {base} status="{status}"/>')
        out.append("    </testsuite>")
    out.append("</testsuites>")
    writer.write("\n".join(out) + "\n")
