"""Structured output: JSON / YAML list of FileReports.

Equivalent of `reporters/validate/structured.rs:20-49`: one combined
report entry per data file (reports for the same data file across rule
files are merged with Status::and semantics).
"""

from __future__ import annotations

import json
from typing import List

import yaml

from ...core.qresult import Status
from ...utils.io import Writer


def combine_reports(reports: List[dict]) -> List[dict]:
    """FileReport::combine (eval_context.rs:1630-1640) keyed by name."""
    by_name = {}
    order = []
    for report in reports:
        name = report["name"]
        if name not in by_name:
            by_name[name] = {
                "name": name,
                "metadata": dict(report["metadata"]),
                "status": report["status"],
                "not_compliant": list(report["not_compliant"]),
                "not_applicable": list(report["not_applicable"]),
                "compliant": list(report["compliant"]),
            }
            order.append(name)
        else:
            agg = by_name[name]
            agg["status"] = Status(agg["status"]).and_(Status(report["status"])).value
            agg["metadata"].update(report["metadata"])
            agg["not_compliant"].extend(report["not_compliant"])
            agg["not_applicable"] = sorted(
                set(agg["not_applicable"]) | set(report["not_applicable"])
            )
            agg["compliant"] = sorted(set(agg["compliant"]) | set(report["compliant"]))
    return [by_name[n] for n in order]


def _strip_locations(reports):
    """Messages.location is serde(skip_serializing) in the reference
    (eval_context.rs:1609-1614): kept internally for SARIF/console code
    excerpts, never serialized into structured output. Walks the known
    report structure only, so embedded template data keeps any
    "location" keys it happens to contain."""
    import copy

    def fix_node(node):
        if "Rule" in node:
            node["Rule"]["messages"].pop("location", None)
            for child in node["Rule"]["checks"]:
                fix_node(child)
        elif "Disjunctions" in node:
            for child in node["Disjunctions"]["checks"]:
                fix_node(child)
        elif "Block" in node:
            node["Block"]["messages"].pop("location", None)
        elif "Clause" in node:
            inner = node["Clause"]
            payload = inner.get("Unary") or inner.get("Binary")
            if payload:
                payload["messages"].pop("location", None)

    out = copy.deepcopy(reports)
    for report in [out] if isinstance(out, dict) else out:
        for node in report.get("not_compliant", []):
            fix_node(node)
    return out


def write_structured(writer: Writer, reports: List[dict], output_format: str) -> None:
    combined = _strip_locations(combine_reports(reports))
    if output_format == "yaml":
        writer.write(
            yaml.safe_dump(
                combined,
                sort_keys=False,
                default_flow_style=False,
                width=2**31,  # serde_yaml never wraps long scalars
            )
        )
    else:
        writer.write(json.dumps(combined, indent=2))
