"""Console reporters of a validate run: the SummaryTable header, the
generic single-line body and the verbose record tree.

Copies of the JAX package's guard_tpu/commands/reporters/console.py.
The verbose tree (`print_verbose_tree`, `-v`) is printed by the
backends off the device only; on the device path `-v` prints nothing
extra, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

from ...core.qresult import Status
from ...core.records import EventRecord, RecordType
from ...utils.io import Writer
from ..report import get_rule_name, iter_clause_failures

SHOW_PASS = "pass"
SHOW_FAIL = "fail"
SHOW_SKIP = "skip"


def summary_table_block(
    writer: Writer,
    data_file: str,
    rules_file: str,
    status: Status,
    rule_statuses: Dict[str, Status],
    show: set,
) -> None:
    """SummaryTable reporter (summary_table.rs:151-237): the leading
    `<file> Status = <s>` header plus SKIP/PASS/FAILED rule lists, each
    section gated by its --show-summary flag; runs before the body
    reporters in the chain (validate.rs:709-716)."""
    if not show:
        return

    def short(n: str) -> str:
        return get_rule_name(rules_file, n)

    # declaration order preserved (summary_table.rs IndexMap semantics)
    passed = [short(n) for n, s in rule_statuses.items() if s == Status.PASS]
    skipped = [short(n) for n, s in rule_statuses.items() if s == Status.SKIP]
    failed = [short(n) for n, s in rule_statuses.items() if s == Status.FAIL]
    longest = max((len(short(n)) for n in rule_statuses), default=0)
    wrote_header = False

    def header():
        nonlocal wrote_header
        if not wrote_header:
            writer.writeln(f"{data_file} Status = {status.value}")
            wrote_header = True

    if SHOW_SKIP in show and skipped:
        header()
        writer.writeln("SKIP rules")
        for n in skipped:
            writer.writeln(f"{rules_file}/{n.ljust(longest + 4)}SKIP")
    if SHOW_PASS in show and passed:
        header()
        writer.writeln("PASS rules")
        for n in passed:
            writer.writeln(f"{rules_file}/{n.ljust(longest + 4)}PASS")
    if SHOW_FAIL in show and failed:
        header()
        writer.writeln("FAILED rules")
        for n in failed:
            writer.writeln(f"{rules_file}/{n.ljust(longest + 4)}FAIL")
    if wrote_header:
        writer.writeln("---")


def generic_single_line(
    writer: Writer,
    data_file: str,
    rules_file: str,
    report: dict,
    rule_statuses: Dict[str, Status],
    show: set,
) -> None:
    """GenericSummary single-line body (generic_summary.rs:262-306):
    per-clause failure messages, then compliant / not-applicable rule
    lines gated by the same --show-summary flags."""
    passed = sorted(n for n, s in rule_statuses.items() if s == Status.PASS)
    skipped = sorted(n for n, s in rule_statuses.items() if s == Status.SKIP)
    failures = list(iter_clause_failures(report))
    # is_reportable priority cascade (generic_summary.rs:157-176): a
    # present FAIL flag alone decides, then PASS, then SKIP.
    if SHOW_FAIL in show:
        reportable = bool(failures)
    elif SHOW_PASS in show:
        reportable = bool(passed)
    else:
        reportable = SHOW_SKIP in show and bool(skipped)
    if not reportable:
        return
    writer.writeln(f"Evaluation of rules {rules_file} against data {data_file}")
    if SHOW_FAIL in show and failures:
        writer.writeln("--")
        for rule_name, clause in failures:
            writer.writeln(_name_info_line(rule_name, data_file, clause))
    if SHOW_PASS in show and passed:
        writer.writeln("--")
        for n in passed:
            writer.writeln(f"Rule [{n}] is compliant for template [{data_file}]")
    if SHOW_SKIP in show and skipped:
        writer.writeln("--")
        for n in skipped:
            writer.writeln(f"Rule [{n}] is not applicable for template [{data_file}]")
    writer.writeln("--")


_UNARY_OP_MSG = {
    "Exists": ("did not exist", "existed"),
    "Empty": ("was not empty", "was empty"),
    "IsList": ("was not a list ", "was list"),
    "IsMap": ("was not a struct", "was struct"),
    "IsString": ("was not a string ", "was string"),
    "IsBool": ("was not a bool", "was bool"),
    "IsInt": ("was not an int", "was int"),
    "IsNull": ("was not null", "was null"),
    "IsFloat": ("was not a float", "was float"),
}


def _jd(v) -> str:
    """serde_json::Value Display: compact separators."""
    import json

    return json.dumps(v, separators=(",", ":"))


def _name_info_line(rule_name: str, data_file: str, clause: dict) -> str:
    """One failure line, NameInfo-style (generic_summary.rs:179-241 +
    common.rs print_name_info:513-646): binary comparisons render
    provided/expected values; unresolved traversals render as retrieval
    errors; unary checks render the operator-specific phrase."""
    check = clause.get("check") or {}
    msgs = clause.get("messages") or {}
    custom = msgs.get("custom_message") or ""
    err_msg = msgs.get("error_message") or ""

    if "Resolved" in check and "from" in check["Resolved"]:
        r = check["Resolved"]
        op, negated = r["comparison"]
        op_msg = "did" if negated else "did not"
        cmp_msg = "match expected value in" if op == "In" else "match expected value"
        return (
            f"Property [{r['from']['path']}] in data [{data_file}] is not "
            f"compliant with [{rule_name}] because provided value "
            f"[{_jd(r['from']['value'])}] {op_msg} {cmp_msg} "
            f"[{_jd(r['to']['value'])}]. Error Message "
            f"[{custom.replace(chr(10), ';')}]"
        )
    if "InResolved" in check:
        r = check["InResolved"]
        op, negated = r["comparison"]
        op_msg = "did" if negated else "did not"
        return (
            f"Property [{r['from']['path']}] in data [{data_file}] is not "
            f"compliant with [{rule_name}] because provided value "
            f"[{_jd(r['from']['value'])}] {op_msg} match expected value in "
            f"[{_jd([t['value'] for t in r.get('to', [])])}]. Error Message "
            f"[{custom.replace(chr(10), ';')}]"
        )
    if "Resolved" in check and "value" in check["Resolved"]:
        # resolved unary check
        r = check["Resolved"]
        op, negated = r["comparison"]
        pair = _UNARY_OP_MSG.get(op, ("did not exist", "existed"))
        op_msg = pair[1] if negated else pair[0]
        return (
            f"Property [{r['value']['path']}] in data [{data_file}] is not "
            f"compliant with [{rule_name}] because needed value at "
            f"[{_jd(r['value']['value'])}] {op_msg}. Error Message "
            f"[{custom.replace(chr(10), ';')}]"
        )
    # unresolved traversals, dependent rules, missing block values:
    # NameInfo.error is set, so the reference prints the retrieval form
    path = _property_path(clause)
    return (
        f"Property traversed until [{path}] in data [{data_file}] is not "
        f"compliant with [{rule_name}] due to retrieval error. Error Message "
        f"[{err_msg}]"
    )


def _property_path(clause: dict) -> str:
    check = clause.get("check", {})
    if "Resolved" in check:
        r = check["Resolved"]
        if "from" in r:
            return r["from"]["path"]
        if "value" in r:
            return r["value"]["path"]
    if "InResolved" in check:
        return check["InResolved"]["from"]["path"]
    if "UnResolved" in check:
        return check["UnResolved"]["value"]["traversed_to"]["path"]
    if "unresolved" in clause and clause["unresolved"]:
        return clause["unresolved"]["traversed_to"]["path"]
    return ""


def _pv_disp(pv) -> str:
    """PathAwareValue Display (display.rs:102-108)."""
    from ...core.values import value_only_display

    return f"Path={pv.self_path().disp()} Value={value_only_display(pv)}"


def _qr_disp(qr) -> str:
    """QueryResult Display (display.rs:109-126)."""
    from ...core.qresult import LITERAL, UNRESOLVED

    if qr is None:
        return ""
    if qr.tag == LITERAL:
        return f"literal, {_pv_disp(qr.value)}"
    if qr.tag == UNRESOLVED:
        return f"(unresolved, {_pv_disp(qr.unresolved.traversed_to)})"
    return f"(resolved, {_pv_disp(qr.value)})"


def _disp_comparison(cmp) -> str:
    """display_comparison (display.rs:9-11): leading space when the
    operator is not negated."""
    op, negated = cmp
    return f"{'not' if negated else ''} {op.display()}"


def _clause_check_disp(cc) -> str:
    """ClauseCheck Display (display.rs:128-199)."""
    from ...core.records import ClauseCheck

    k = cc.kind
    if k == ClauseCheck.SUCCESS:
        return "GuardClauseValueCheck(Status=PASS)"
    if k == ClauseCheck.NO_VALUE_FOR_EMPTY:
        return f"GuardClause(Status=FAIL, Empty, {cc.payload or ''})"
    if k == ClauseCheck.MISSING_BLOCK_VALUE:
        m = cc.payload
        traversed = ""
        if m.from_.unresolved is not None:
            traversed = m.from_.unresolved.traversed_to.self_path().s
        return (
            f"GuardBlockValueMissing(Status={m.status.value}, "
            f"Reason={m.message or ''}, {traversed})"
        )
    if k == ClauseCheck.DEPENDENT_RULE:
        m = cc.payload
        return f"GuardClauseDependentRule(Rule={m.rule}, Status={m.status.value})"
    if k == ClauseCheck.UNARY:
        u = cc.payload
        return (
            f"GuardClauseUnaryCheck(Status={u.value.status.value}, "
            f"Comparison={_disp_comparison(u.comparison)}, "
            f"Value-At={_qr_disp(u.value.from_)})"
        )
    if k == ClauseCheck.COMPARISON:
        c = cc.payload
        return (
            f"GuardClauseBinaryCheck(Status={c.status.value}, "
            f"Comparison={_disp_comparison(c.comparison)}, "
            f"from={_qr_disp(c.from_)}, to={_qr_disp(c.to)})"
        )
    # InComparison: SliceDisplay over the to-results (exprs.rs:287-303)
    c = cc.payload
    joined = ".".join(_qr_disp(t) for t in c.to).replace(".[", "[")
    return (
        f"GuardClauseInBinaryCheck(Status={c.status.value}, "
        f"Comparison={_disp_comparison(c.comparison)}, "
        f"from={_qr_disp(c.from_)}, to={joined})"
    )


def _record_disp(rt: RecordType) -> str:
    """RecordType Display (display.rs:201-318) — including the
    reference's unbalanced parens on TypeBlock variants."""
    k, p = rt.kind, rt.payload
    if k == RecordType.FILE_CHECK:
        return f"File({p.name}, Status={p.status.value})"
    if k == RecordType.RULE_CHECK:
        return f"Rule({p.name}, Status={p.status.value})"
    if k == RecordType.RULE_CONDITION:
        return f"Rule/When(Status={p.value})"
    if k == RecordType.TYPE_CHECK:
        return f"Type({p.type_name}, Status={p.block.status.value})"
    if k == RecordType.TYPE_CONDITION:
        return f"TypeBlock/When Status={p.value})"
    if k == RecordType.TYPE_BLOCK:
        return f"TypeBlock/Block Status={p.value})"
    if k == RecordType.FILTER:
        return f"Filter/ConjunctionsBlock(Status={p.value})"
    if k == RecordType.WHEN_CHECK:
        return f"WhenConditionalBlock(Status = {p.status.value})"
    if k == RecordType.WHEN_CONDITION:
        return f"WhenCondition(Status = {p.value})"
    if k == RecordType.DISJUNCTION:
        return f"Disjunction(Status = {p.status.value})"
    if k == RecordType.BLOCK_GUARD_CHECK:
        return f"GuardValueBlockCheck(Status = {p.status.value})"
    if k == RecordType.GUARD_CLAUSE_BLOCK_CHECK:
        return f"GuardClauseBlock(Status = {p.status.value})"
    return _clause_check_disp(p)


def print_verbose_tree(writer: Writer, record: EventRecord, indent: int = 0) -> None:
    """validate.rs:668-687 pprint_tree: `|- `/`` `- `` prefixes with
    `{RecordType}[Context={context}]` lines."""

    def walk(rec: EventRecord, prefix: str, last: bool) -> None:
        head = "`- " if last else "|- "
        writer.writeln(f"{prefix}{head}{_record_disp(rec.container)}[Context={rec.context}]")
        child_prefix = prefix + ("   " if last else "|  ")
        for i, child in enumerate(rec.children):
            walk(child, child_prefix, i == len(rec.children) - 1)

    walk(record, "", True)


