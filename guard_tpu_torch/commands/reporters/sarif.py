"""SARIF 2.1.0 output for code-scanning integrations.

Byte-level equivalent of `reporters/validate/sarif.rs` (the reference's
structured.sarif golden, modulo tool identity): one SARIF run over the
FAILing file reports; one artifact per unique failing file; one result
per leaf Messages in each top-level failing rule's subtree (ClauseReport
::get_message, eval_context.rs:1808-1830); ruleId = the rule name up to
the first '.' upper-cased (sarif.rs extract_rule_id); message text =
"{error_message} {custom_message}"; region from the message location
clamped to 1."""

from __future__ import annotations

import json
from typing import List

from ...utils.io import Writer

SARIF_SCHEMA = (
    "https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/os/schemas/"
    "sarif-schema-2.1.0.json"
)
TOOL_NAME = "guard-tpu"
TOOL_VERSION = "0.1.0"
TOOL_REPO = "https://github.com/guard-tpu/guard-tpu"
ORGANIZATION = "guard-tpu authors"
TOOL_DESCRIPTION = (
    "guard-tpu is an open-source general-purpose policy-as-code evaluation "
    "tool with a TPU batch-evaluation engine. It provides developers with a "
    "simple-to-use, yet powerful and expressive domain-specific language "
    "(DSL) to define policies and enables developers to validate JSON- or "
    "YAML- formatted structured data with those policies."
)


def _sanitize_path(path: str) -> str:
    return path[1:] if path.startswith("/") else path


def _extract_rule_id(rule_name: str) -> str:
    """sarif.rs:229-235: text before the first '.', upper-cased."""
    return rule_name.split(".")[0].upper() if rule_name else ""


def _rule_messages(node: dict) -> List[dict]:
    """ClauseReport::get_message (eval_context.rs:1808-1830)."""
    if "Rule" in node:
        out: List[dict] = []
        for child in node["Rule"]["checks"]:
            out.extend(_rule_messages(child))
        return out
    if "Disjunctions" in node:
        out = []
        for child in node["Disjunctions"]["checks"]:
            out.extend(_rule_messages(child))
        return out
    if "Block" in node:
        return [node["Block"].get("messages") or {}]
    if "Clause" in node:
        inner = node["Clause"]
        payload = inner.get("Unary") or inner.get("Binary") or {}
        return [payload.get("messages") or {}]
    return []


def build_sarif(file_reports: List[dict]) -> dict:
    artifacts = []
    seen = set()
    results = []
    for report in file_reports:
        if report["status"] != "FAIL":
            continue
        name = report["name"]
        if name and name not in seen:
            seen.add(name)
            artifacts.append({"location": {"uri": _sanitize_path(name)}})
        for failure in report["not_compliant"]:
            rule_id = ""
            if "Rule" in failure:
                rule_id = _extract_rule_id(failure["Rule"]["name"])
            for msgs in _rule_messages(failure):
                loc = msgs.get("location") or {}
                line = int(loc.get("line") or 0)
                col = int(loc.get("col") or 0)
                text = (
                    f"{msgs.get('error_message') or ''} "
                    f"{msgs.get('custom_message') or ''}"
                )
                results.append(
                    {
                        "ruleId": rule_id,
                        "level": "error",
                        "message": {"text": text},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {
                                        "uri": _sanitize_path(name)
                                    },
                                    "region": {
                                        "startLine": max(line, 1),
                                        "startColumn": max(col, 1),
                                    },
                                }
                            }
                        ],
                    }
                )
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        "semanticVersion": TOOL_VERSION,
                        "fullName": f"{TOOL_NAME} {TOOL_VERSION}",
                        "organization": ORGANIZATION,
                        "downloadUri": TOOL_REPO,
                        "informationUri": TOOL_REPO,
                        "shortDescription": {"text": TOOL_DESCRIPTION},
                    }
                },
                "artifacts": artifacts,
                "results": results,
            }
        ],
    }


def write_sarif(writer: Writer, file_reports: List[dict]) -> None:
    writer.write(json.dumps(build_sarif(file_reports), indent=2))
