"""Template-aware console reporters for CloudFormation and Terraform.

Equivalent of the reference's chain-of-responsibility reporter stack
`GenericSummary -> TfAware -> CfnAware` (built in
`guard/src/commands/validate.rs:703-716`): validate's
console path first offers the evaluation to the CloudFormation reporter
(`reporters/validate/cfn.rs:44` — applies when the document has a
`Resources` root key, aggregates failures per resource and excerpts the
offending source lines), then the Terraform-plan reporter
(`reporters/validate/tf.rs:16` — applies when the document has a
`resource_changes` root key), and only falls back to the generic
single-line summary when neither shape matches or resource attribution
fails (`cfn.rs:196-207` falls back via InternalError).

Here each specialization is a function returning True when it handled
the report; `console_chain` tries cfn -> tf -> generic in that order.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ...core.exprs import CmpOperator
from ...core.values import MAP, PV
from ...utils.io import Writer
from ..report import iter_clause_failures

def _top_level_json_keys(content: str):
    """Top-level object keys of a JSON document without building the
    tree; None when the content isn't a JSON object parse (YAML,
    scalars, garbage — the caller materializes the real tree then),
    an empty set for arrays (neither cfn nor tf shape applies)."""
    n = len(content)

    def skip_ws(i):
        while i < n and content[i] in " \t\r\n":
            i += 1
        return i

    def skip_string(i):
        """i at the opening quote; returns index past the close, or -1."""
        i += 1
        while i < n:
            c = content[i]
            if c == "\\":
                i += 2
                continue
            if c == '"':
                return i + 1
            i += 1
        return -1

    i = skip_ws(0)
    if i >= n:
        return None
    if content[i] == "[":
        return set()
    if content[i] != "{":
        return None
    i += 1
    keys = set()
    while True:
        i = skip_ws(i)
        if i >= n:
            return None
        if content[i] == "}":
            return keys
        if content[i] == ",":
            i += 1
            continue
        if content[i] != '"':
            return None
        close = skip_string(i)
        if close < 0:
            return None
        raw_key = content[i + 1 : close - 1]
        if "\\" in raw_key:
            # escaped spellings (\u0052esources...) need the real
            # parser — decline the probe entirely
            return None
        keys.add(raw_key)
        i = skip_ws(close)
        if i >= n or content[i] != ":":
            return None
        i = skip_ws(i + 1)
        if i >= n:
            return None
        c = content[i]
        if c == '"':
            i = skip_string(i)
            if i < 0:
                return None
        elif c in "{[":
            depth = 1
            i += 1
            while i < n and depth:
                ch = content[i]
                if ch == '"':
                    i = skip_string(i)
                    if i < 0:
                        return None
                    continue
                if ch in "{[":
                    depth += 1
                elif ch in "}]":
                    depth -= 1
                i += 1
            if depth:
                return None
        else:
            while i < n and content[i] not in ",}":
                i += 1


def console_chain(
    writer: Writer,
    data_file_name: str,
    data_content: str,
    data_pv: PV,
    rules_file_name: str,
    status,
    rule_statuses,
    report: dict,
    show_summary,
    output_format: str = "single-line-summary",
) -> None:
    """The full console chain for one (rules, data) pair: SummaryTable
    header, then CfnAware -> TfAware -> generic body for the
    single-line format (validate.rs:703-716), or the serialized
    FileReport for `-o json|yaml` without --structured
    (generic_summary.rs:104-105 / cfn.rs:86-87). `show_summary` is the
    raw --show-summary list."""
    from .console import generic_single_line, summary_table_block

    show = set(show_summary)
    if "all" in show:
        show = {"pass", "fail", "skip"}
    show.discard("none")
    summary_table_block(
        writer, data_file_name, rules_file_name, status, rule_statuses, show
    )
    if output_format in ("json", "yaml"):
        import json as _json

        import yaml as _yaml

        from .structured import _strip_locations

        rep = _strip_locations(report)
        if output_format == "yaml":
            writer.write(
                _yaml.safe_dump(
                    rep, sort_keys=False, default_flow_style=False, width=2**31
                )
            )
        else:
            writer.write(_json.dumps(rep, indent=2))
        return
    # `data_pv` may be a DataFile whose tree builds lazily. The aware
    # reporters read the tree only for shape detection plus failure
    # attribution; for reports with no failing clause (passing
    # documents, and the clause-free reports of --statuses-only) the
    # shape answer (has a top-level "Resources" / "resource_changes"
    # key?) comes from a raw-JSON key scan when the tree is not built,
    # so those documents never build one.
    pv = data_pv
    if not isinstance(data_pv, PV):  # a DataFile: tree builds lazily
        if data_pv._pv is None and not any(
            next(_leaves(r), None) is not None for r in report["not_compliant"]
        ):
            keys = getattr(data_pv, "_top_keys", False)
            if keys is False:
                keys = _top_level_json_keys(data_content)
                data_pv._top_keys = keys
            if keys is not None:
                if "Resources" in keys or "resource_changes" in keys:
                    # cfn/tf applies; no clause to attribute to a resource
                    if report["not_compliant"]:
                        writer.writeln(
                            f"Evaluating data {data_file_name} against rules {rules_file_name}"
                        )
                        writer.writeln("Number of non-compliant resources 0")
                    return
                generic_single_line(
                    writer, data_file_name, rules_file_name, report,
                    rule_statuses, show,
                )
                return
        pv = data_pv.path_value
    handled = cfn_single_line(
        writer, data_file_name, data_content, rules_file_name, pv, report
    ) or tf_single_line(writer, data_file_name, rules_file_name, pv, report)
    if not handled:
        generic_single_line(
            writer, data_file_name, rules_file_name, report, rule_statuses, show
        )


_TF_RESOURCE = re.compile(r"^/resource_changes/(?P<idx>[^/]+)")

_WIDTH = len("PropertyPath") + 4


def _cmp_str(comparison) -> str:
    """eval_context.rs:1847-1960 operator display strings."""
    if not comparison:
        return ""
    op_s, negated = comparison
    op = CmpOperator(op_s)
    unary = {
        CmpOperator.Exists: ("EXISTS", "NOT EXISTS"),
        CmpOperator.Empty: ("EMPTY", "NOT EMPTY"),
        CmpOperator.IsList: ("IS LIST", "NOT LIST"),
        CmpOperator.IsMap: ("IS STRUCT", "NOT STRUCT"),
        CmpOperator.IsString: ("IS STRING", "NOT STRING"),
        CmpOperator.IsFloat: ("IS FLOAT", "NOT FLOAT"),
        CmpOperator.IsNull: ("IS NULL", "NOT NULL"),
        CmpOperator.IsBool: ("IS BOOl", "NOT BOOL"),
        CmpOperator.IsInt: ("IS INT", "NOT INT"),
    }
    binary = {
        CmpOperator.Eq: ("EQUAL", "NOT EQUAL"),
        CmpOperator.Le: ("LESS THAN EQUAL", "NOT LESS THAN EQUAL"),
        CmpOperator.Lt: ("LESS THAN", "NOT LESS THAN"),
        CmpOperator.Ge: ("GREATER THAN EQUAL", "NOT GREATER THAN EQUAL"),
        CmpOperator.Gt: ("GREATER THAN", "NOT GREATER THAN"),
        CmpOperator.In: ("IN", "NOT IN"),
    }
    table = unary if op.is_unary() else binary
    pos, neg = table.get(op, (op_s, f"NOT {op_s}"))
    return neg if negated else pos


def _map_get(pv: Optional[PV], key: str) -> Optional[PV]:
    if pv is None or pv.kind != MAP:
        return None
    return pv.val.values.get(key)


def _scalar(pv: Optional[PV]):
    if pv is None or not pv.is_scalar():
        return None
    return pv.val


def _clause_anchor_path(clause: dict) -> str:
    check = clause.get("check") or {}
    if "Resolved" in check:
        r = check["Resolved"]
        node = r.get("from") or r.get("value")
        if node:
            return node["path"]
    if "InResolved" in check:
        return check["InResolved"]["from"]["path"]
    if "UnResolved" in check:
        return check["UnResolved"]["value"]["traversed_to"]["path"]
    ur = clause.get("unresolved")
    if ur:
        return ur["traversed_to"]["path"]
    return ""


def _fmt_value(v) -> str:
    import json

    return json.dumps(v)


class _CodeExcerpt:
    """ReadCursor-style source excerpts (utils/mod.rs:7-66, cfn.rs emit_code):
    the failing line minus two, plus ~6 lines of following context."""

    def __init__(self, content: str):
        self.lines = content.splitlines()

    def emit(self, writer: Writer, line: Optional[int], prefix: str) -> None:
        if not line or not self.lines:
            return
        writer.writeln(f"{prefix}Code:")
        # cfn.rs:392-417 — the line at (failing - 2) plus 5 context lines
        start = max(1, line - 2)
        for num in range(start, min(start + 6, len(self.lines) + 1)):
            writer.writeln(f"{prefix}  {num:>5}.{self.lines[num - 1]}")


def _emit_clause(
    writer: Writer,
    clause: dict,
    prefix: str,
    excerpt: Optional[_CodeExcerpt],
    path_rewrite=None,
) -> None:
    msgs = clause.get("messages") or {}
    custom = msgs.get("custom_message") or ""
    location = msgs.get("location") or {}
    line = location.get("line")
    context = clause.get("context", "")
    check = clause.get("check") or {}
    writer.writeln(f"{prefix}Check = {context} {{")
    inner = prefix + "  "
    field = prefix + "    "
    if custom:
        writer.writeln(f"{inner}Message {{")
        for ln in custom.split(";"):
            writer.writeln(f"{field}{ln.strip()}")
        writer.writeln(f"{inner}}}")
    if "UnResolved" in check or (clause.get("unresolved") is not None):
        ur = (
            check.get("UnResolved", {}).get("value")
            or clause.get("unresolved")
            or {}
        )
        comparison = check.get("UnResolved", {}).get("comparison")
        writer.writeln(f"{inner}RequiredPropertyError {{")
        traversed = ur.get("traversed_to", {})
        writer.writeln(
            f"{field}{'PropertyPath':<{_WIDTH}}= {traversed.get('path', '')}"
        )
        writer.writeln(
            f"{field}{'MissingProperty':<{_WIDTH}}= {ur.get('remaining_query', '')}"
        )
        if comparison:
            writer.writeln(f"{field}{'Operator':<{_WIDTH}}= {_cmp_str(comparison)}")
        reason = ur.get("reason")
        if reason:
            writer.writeln(f"{field}{'Reason':<{_WIDTH}}= {reason}")
        if excerpt is not None:
            excerpt.emit(writer, line, field)
        writer.writeln(f"{inner}}}")
    elif "Resolved" in check and "from" in check["Resolved"]:
        r = check["Resolved"]
        path = r["from"]["path"]
        if path_rewrite:
            path = path_rewrite(path)
        writer.writeln(f"{inner}ComparisonError {{")
        writer.writeln(f"{field}{'PropertyPath':<{_WIDTH}}= {path}")
        writer.writeln(f"{field}{'Operator':<{_WIDTH}}= {_cmp_str(r.get('comparison'))}")
        writer.writeln(f"{field}{'Value':<{_WIDTH}}= {_fmt_value(r['from']['value'])}")
        writer.writeln(f"{field}{'ComparedWith':<{_WIDTH}}= {_fmt_value(r['to']['value'])}")
        if excerpt is not None:
            excerpt.emit(writer, line, field)
        writer.writeln(f"{inner}}}")
    elif "InResolved" in check:
        r = check["InResolved"]
        path = r["from"]["path"]
        if path_rewrite:
            path = path_rewrite(path)
        to_vals = [t["value"] for t in r.get("to", [])]
        cut_off = max(len(to_vals), 5)
        shown = to_vals[: cut_off + 1]
        writer.writeln(f"{inner}ComparisonError {{")
        writer.writeln(f"{field}{'PropertyPath':<{_WIDTH}}= {path}")
        writer.writeln(f"{field}{'Operator':<{_WIDTH}}= {_cmp_str(r.get('comparison'))}")
        if len(shown) < len(to_vals):
            writer.writeln(f"{field}{'Total':<{_WIDTH}}= {len(to_vals)}")
        writer.writeln(f"{field}{'Value':<{_WIDTH}}= {_fmt_value(r['from']['value'])}")
        writer.writeln(
            f"{field}{'ComparedWith':<{_WIDTH}}= {[_fmt_value(v) for v in shown]}"
        )
        if excerpt is not None:
            excerpt.emit(writer, line, field)
        writer.writeln(f"{inner}}}")
    elif "Resolved" in check and "value" in check["Resolved"]:
        r = check["Resolved"]
        path = r["value"]["path"]
        if path_rewrite:
            path = path_rewrite(path)
        writer.writeln(f"{inner}ComparisonError {{")
        writer.writeln(f"{field}{'PropertyPath':<{_WIDTH}}= {path}")
        writer.writeln(f"{field}{'Operator':<{_WIDTH}}= {_cmp_str(r.get('comparison'))}")
        if excerpt is not None:
            excerpt.emit(writer, line, field)
        writer.writeln(f"{inner}}}")
    else:
        err = msgs.get("error_message") or ""
        if err:
            writer.writeln(f"{inner}Error = {err}")
    writer.writeln(f"{prefix}}}")


def _group_failures(
    report: dict, pattern: re.Pattern, floor: str
) -> Optional[Dict[str, List[Tuple[str, dict]]]]:
    """Group failing clauses by resource key. The reference only
    considers paths sorting lexicographically >= the resource-section
    floor (cfn.rs:180 `path_tree.range("/Resources"..)`), so failures
    anchored before it (root-level properties) are silently dropped;
    a path at-or-after the floor that still cannot be attributed falls
    back to the generic reporter (cfn.rs:196-207 InternalError)."""
    groups: Dict[str, List[Tuple[str, dict]]] = {}
    for rule_name, clause in iter_clause_failures(report):
        path = _clause_anchor_path(clause)
        if path < floor:
            continue
        m = pattern.match(path)
        if not m:
            return None
        groups.setdefault(m.group(1), []).append((rule_name, clause))
    return groups


def _node_paths(leaf: dict) -> List[str]:
    """value_from/value_to paths of a leaf clause/block node
    (common.rs insert_into_trees)."""
    paths: List[str] = []
    if "Clause" in leaf:
        payload = leaf["Clause"].get("Unary") or leaf["Clause"].get("Binary") or {}
        check = payload.get("check") or {}
        if "Resolved" in check:
            r = check["Resolved"]
            if "from" in r:
                paths.append(r["from"]["path"])
                if "to" in r:
                    paths.append(r["to"]["path"])
            elif "value" in r:
                paths.append(r["value"]["path"])
        elif "InResolved" in check:
            paths.append(check["InResolved"]["from"]["path"])
        elif "UnResolved" in check:
            paths.append(check["UnResolved"]["value"]["traversed_to"]["path"])
    elif "Block" in leaf:
        ur = leaf["Block"].get("unresolved")
        if ur:
            paths.append(ur["traversed_to"]["path"])
    return paths


def _leaves(node: dict):
    if "Rule" in node:
        for child in node["Rule"]["checks"]:
            yield from _leaves(child)
    elif "Disjunctions" in node:
        for child in node["Disjunctions"]["checks"]:
            yield from _leaves(child)
    else:
        yield node


def _emit_messages(writer: Writer, prefix: str, custom: str, error: str, width: int) -> None:
    """common.rs emit_messages:762-823."""
    if custom:
        parts = custom.split(";") if ";" in custom else custom.split("\n")
        parts = [p.strip() for p in parts]
        parts = [p for p in parts if p]
        if len(parts) > 1:
            writer.writeln(f"{prefix}{'Message':<{width}} {{")
            for p in parts:
                writer.writeln(f"{prefix}  {p}")
            writer.writeln(f"{prefix}}}")
        elif parts:
            writer.writeln(f"{prefix}{'Message':<{width}} = {parts[0]}")
    if error:
        writer.writeln(f"{prefix}{'Error':<{width}} = {error}")


def _plain_value_display(v) -> str:
    from ...core.values import plain_value_display

    return plain_value_display(v)


def _loc_disp(path: str, msgs: dict) -> str:
    loc = (msgs or {}).get("location") or {}
    return f"{path}[L:{loc.get('line', 0)},C:{loc.get('col', 0)}]"


def _pprint_clauses(
    writer: Writer,
    node: dict,
    members: set,
    prefix: str,
    excerpt: Optional[_CodeExcerpt],
    rules_file: str,
) -> None:
    """common.rs pprint_clauses:919-1100 with the cfn.rs ErrWriter field
    and code-excerpt emission inlined."""
    if "Rule" in node:
        rr = node["Rule"]
        writer.writeln(f"{prefix}Rule = {rr['name']} {{")
        p2 = prefix + "  "
        msgs = rr.get("messages") or {}
        _emit_messages(
            writer, p2, msgs.get("custom_message") or "", msgs.get("error_message") or "", 0
        )
        writer.writeln(f"{p2}ALL {{")
        p3 = p2 + "  "
        for child in rr["checks"]:
            _pprint_clauses(writer, child, members, p3, excerpt, rules_file)
        writer.writeln(f"{p2}}}")
        writer.writeln(f"{prefix}}}")
        return
    if "Disjunctions" in node:
        writer.writeln(f"{prefix}ANY {{")
        p2 = prefix + "  "
        for child in node["Disjunctions"]["checks"]:
            _pprint_clauses(writer, child, members, p2, excerpt, rules_file)
        writer.writeln(f"{prefix}}}")
        return
    if id(node) not in members:
        return
    if "Block" in node:
        blk = node["Block"]
        msgs = blk.get("messages") or {}
        writer.writeln(f"{prefix}Check = {blk.get('context', '')} {{")
        p2 = prefix + "  "
        writer.writeln(f"{p2}RequiredPropertyError {{")
        p3 = p2 + "  "
        ur = blk.get("unresolved")
        width = len("Message") + 4
        if ur and ur["traversed_to"]["path"]:
            width = len("MissingProperty") + 4
            writer.writeln(f"{p3}{'PropertyPath':<{width}}= {ur['traversed_to']['path']}")
            writer.writeln(f"{p3}{'MissingProperty':<{width}}= {ur['remaining_query']}")
        _emit_messages(
            writer, p3, msgs.get("custom_message") or "", msgs.get("error_message") or "", width
        )
        # the reference buffers the code excerpt and writeln!s the
        # buffer afterwards, leaving a blank line (common.rs:1030-1042)
        if excerpt is not None and ur:
            loc = msgs.get("location") or {}
            excerpt.emit(writer, loc.get("line"), p3)
        writer.writeln("")
        writer.writeln(f"{p2}}}")
        writer.writeln(f"{prefix}}}")
        return
    payload = node["Clause"].get("Unary") or node["Clause"].get("Binary") or {}
    check = payload.get("check") or {}
    msgs = payload.get("messages") or {}
    context = payload.get("context", "")
    custom = msgs.get("custom_message") or ""
    error = msgs.get("error_message") or ""
    width = len("PropertyPath") + 4
    if "UnResolved" in check:
        # emit_retrieval_error (common.rs:826-876): unpadded fields,
        # PropertyPath carries the source location
        ur = check["UnResolved"]["value"]
        writer.writeln(f"{prefix}Check = {context} {{")
        p2 = prefix + "  "
        _emit_messages(writer, p2, custom, "", 0)
        writer.writeln(f"{p2}RequiredPropertyError {{")
        p3 = p2 + "  "
        writer.writeln(
            f"{p3}PropertyPath = {_loc_disp(ur['traversed_to']['path'], msgs)}"
        )
        writer.writeln(f"{p3}MissingProperty = {ur['remaining_query']}")
        if ur.get("reason"):
            writer.writeln(f"{p3}Reason = {ur['reason']}")
        if excerpt is not None:
            loc = msgs.get("location") or {}
            excerpt.emit(writer, loc.get("line"), p3)
        writer.writeln(f"{p2}}}")
        writer.writeln(f"{prefix}}}")
        return
    writer.writeln(f"{prefix}Check = {context} {{")
    p2 = prefix + "  "
    writer.writeln(f"{p2}ComparisonError {{")
    p3 = p2 + "  "
    loc = msgs.get("location") or {}
    # the reference buffers the field lines + code excerpt, emits
    # Message/Error first, then writeln!s the buffer — so messages come
    # first and a blank line trails the block (common.rs:1112-1148)
    _emit_messages(writer, p3, custom, error, width)
    if "Resolved" in check and "from" in check["Resolved"]:
        r = check["Resolved"]
        writer.writeln(f"{p3}{'PropertyPath':<{width}}= {_loc_disp(r['from']['path'], msgs)}")
        writer.writeln(f"{p3}{'Operator':<{width}}= {_cmp_str(r.get('comparison'))}")
        writer.writeln(
            f"{p3}{'Value':<{width}}= {_plain_value_display(r['from']['value'])}"
        )
        writer.writeln(
            f"{p3}{'ComparedWith':<{width}}= {_plain_value_display(r['to']['value'])}"
        )
        if excerpt is not None:
            excerpt.emit(writer, loc.get("line"), p3)
    elif "InResolved" in check:
        r = check["InResolved"]
        to_vals = [t["value"] for t in r.get("to", [])]
        cut_off = max(len(to_vals), 5)
        shown = to_vals[: cut_off + 1]
        writer.writeln(f"{p3}{'PropertyPath':<{width}}= {_loc_disp(r['from']['path'], msgs)}")
        writer.writeln(f"{p3}{'Operator':<{width}}= {_cmp_str(r.get('comparison'))}")
        if cut_off < len(to_vals):
            writer.writeln(f"{p3}{'Total':<{width}}= {len(to_vals)}")
        writer.writeln(
            f"{p3}{'Value':<{width}}= {_plain_value_display(r['from']['value'])}"
        )
        collected = "[" + ", ".join(_plain_value_display(v) for v in shown) + "]"
        writer.writeln(f"{p3}{'ComparedWith':<{width}}= {collected}")
        if excerpt is not None:
            excerpt.emit(writer, loc.get("line"), p3)
    elif "Resolved" in check and "value" in check["Resolved"]:
        r = check["Resolved"]
        writer.writeln(f"{p3}{'PropertyPath':<{width}}= {_loc_disp(r['value']['path'], msgs)}")
        writer.writeln(f"{p3}{'Operator':<{width}}= {_cmp_str(r.get('comparison'))}")
        if excerpt is not None:
            excerpt.emit(writer, loc.get("line"), p3)
    writer.writeln("")
    writer.writeln(f"{p2}}}")
    writer.writeln(f"{prefix}}}")


def cfn_single_line(
    writer: Writer,
    data_file: str,
    data_content: str,
    rules_file: str,
    doc: PV,
    report: dict,
) -> bool:
    """CfnAware single-line summary (cfn.rs:157-420). Returns True when
    this reporter applies and handled the output. Failures anchored at
    paths sorting before "/Resources" are silently dropped (cfn.rs:180
    path_tree.range); a path at-or-after that cannot be attributed to a
    known resource falls back to the generic reporter (cfn.rs:196-207)."""
    resources = _map_get(doc, "Resources")
    if resources is None:
        return False
    if not report["not_compliant"]:
        return True

    def resource_name_of(path: str) -> Optional[str]:
        """Resource names may themselves contain '/' (cfn.rs:183-194
        probes progressively longer names against the template)."""
        if not path.startswith("/Resources/"):
            return None
        segs = path[len("/Resources/"):].split("/")
        for i in range(1, len(segs) + 1):
            name = "/".join(segs[:i])
            if _map_get(resources, name) is not None:
                return name
        return None

    members_by_resource: Dict[str, set] = {}
    for rule_node in report["not_compliant"]:
        for leaf in _leaves(rule_node):
            for path in _node_paths(leaf):
                if path < "/Resources":
                    continue
                name = resource_name_of(path)
                if name is None:
                    return False
                members_by_resource.setdefault(name, set()).add(id(leaf))

    excerpt = _CodeExcerpt(data_content)
    writer.writeln(f"Evaluating data {data_file} against rules {rules_file}")
    writer.writeln(f"Number of non-compliant resources {len(members_by_resource)}")
    for name in sorted(members_by_resource):
        members = members_by_resource[name]
        res = _map_get(resources, name)
        res_type = _scalar(_map_get(res, "Type")) or ""
        cdk_path = _scalar(_map_get(_map_get(res, "Metadata"), "aws:cdk:path"))
        writer.writeln(f"Resource = {name} {{")
        writer.writeln(f"  {'Type':<10}= {res_type}")
        if cdk_path:
            writer.writeln(f"  {'CDK-Path':<10}= {cdk_path}")
        for rule_node in report["not_compliant"]:
            if any(id(leaf) in members for leaf in _leaves(rule_node)):
                _pprint_clauses(writer, rule_node, members, "  ", excerpt, rules_file)
        writer.writeln("}")
    return True


def _tf_property(path: str) -> str:
    """tf.rs:215-231 — show the property below change/after as dotted."""
    idx = path.find("change/after/")
    if idx < 0:
        return path
    return path[idx + len("change/after/") :].replace("/", ".")


def tf_single_line(
    writer: Writer,
    data_file: str,
    rules_file: str,
    doc: PV,
    report: dict,
) -> bool:
    """TfAware single-line summary (tf.rs:100-300). Returns True when the
    document is a Terraform plan and output was handled."""
    changes = _map_get(doc, "resource_changes")
    if changes is None:
        return False
    if not report["not_compliant"]:
        return True
    groups = _group_failures(report, _TF_RESOURCE, "/resource_changes")
    if groups is None:
        return False

    # resource_changes[idx].address = "<type>.<name>" (tf.rs:134-141)
    def addr_of(idx: str) -> Tuple[str, str]:
        entry = None
        if changes.is_list():
            try:
                entry = changes.val[int(idx)]
            except (ValueError, IndexError):
                entry = None
        elif changes.kind == MAP:
            entry = changes.val.values.get(idx)
        addr = _scalar(_map_get(entry, "address")) or ""
        dot = addr.find(".")
        if dot < 0:
            return addr, addr
        return addr[:dot], addr[dot + 1 :]

    named: Dict[str, Tuple[str, List[Tuple[str, dict]]]] = {}
    for idx, clauses in groups.items():
        rtype, rname = addr_of(idx)
        prev = named.get(rname)
        if prev:
            prev[1].extend(clauses)
        else:
            named[rname] = (rtype, list(clauses))

    writer.writeln(f"Evaluating data {data_file} against rules {rules_file}")
    writer.writeln(f"Number of non-compliant resources {len(named)}")
    for rname in sorted(named):
        rtype, clauses = named[rname]
        writer.writeln(f"Resource = {rname} {{")
        writer.writeln(f"  {'Type':<10}= {rtype}")
        by_rule: Dict[str, List[dict]] = {}
        for rule_name, clause in clauses:
            by_rule.setdefault(rule_name, []).append(clause)
        for rule_name in sorted(by_rule):
            writer.writeln(f"  Rule = {rule_name} {{")
            for clause in by_rule[rule_name]:
                _emit_clause(writer, clause, "    ", None, path_rewrite=_tf_property)
            writer.writeln("  }")
        writer.writeln("}")
    return True
