"""What `sweep` must answer for one document, from the texts alone.

For each rules file in the order `sweep` gathers them (sorted by path),
the evaluator's status of each rule; a later file's rule of the same
name replaces an earlier one's. The document's status is FAIL if any
rule fails, else PASS if any passes, else SKIP, and its failing rules
are listed by name. A rules file on which the evaluator raises counts
one error and adds no statuses.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .guard.errors import GuardError
from .guard.evaluator import eval_rules_file
from .guard.loader import load_document
from .guard.parser import parse_rules_file
from .guard.qresult import Status
from .guard.records import EventRecord, RecordType
from .guard.scopes import RootScope

RULE_FILE_EXTENSIONS = (".guard", ".ruleset")

# deep documents recurse in the evaluator and the loader
sys.setrecursionlimit(max(sys.getrecursionlimit(), 20000))


def load_rules(rules_dir) -> List[Tuple[str, object]]:
    """(file name, parsed rules) of every rules file under rules_dir,
    in sweep's order."""
    paths = sorted(
        (p for p in Path(rules_dir).rglob("*") if p.suffix.lower() in RULE_FILE_EXTENSIONS),
        key=str,
    )
    return [(p.name, parse_rules_file(p.read_text(), p.name)) for p in paths]


def rule_statuses(root: EventRecord) -> Dict[str, Status]:
    """Top-level rule name -> status of one file's evaluation."""
    out: Dict[str, Status] = {}
    for each in root.children:
        c = each.container
        if c is not None and c.kind == RecordType.RULE_CHECK:
            name = c.payload.name
            prev = out.get(name)
            if prev is None or (prev == Status.SKIP and c.payload.status != Status.SKIP):
                out[name] = c.payload.status
            elif c.payload.status == Status.FAIL:
                out[name] = Status.FAIL
    return out


def outcome(rules, name: str, text: str) -> dict:
    """{"status": pass|fail|skip, "fails": sorted names, "raised": the
    files on which the evaluator raised}."""
    pv = load_document(text, name)
    merged: Dict[str, Status] = {}
    raised: List[str] = []
    for file_name, rf in rules:
        try:
            scope = RootScope(rf, pv)
            eval_rules_file(rf, scope, name)
        except GuardError:
            raised.append(file_name)
            continue
        merged.update(rule_statuses(scope.reset_recorder().extract()))
    status = Status.SKIP
    for st in merged.values():
        status = status.and_(st)
    fails = sorted(n for n, st in merged.items() if st == Status.FAIL)
    return {"status": status.value.lower(), "fails": fails, "raised": raised}


# -- a spawn pool's worker: the rules parsed once a process ----------
_RULES: Optional[list] = None


def init_worker(rules_dir: str) -> None:
    global _RULES
    _RULES = load_rules(rules_dir)


def outcome_of(item: Tuple[str, str]) -> dict:
    name, text = item
    return outcome(_RULES, name, text)


def truncated(text: str, cap: int) -> str:
    """The document with its Resources cut to the first `cap`."""
    doc = json.loads(text)
    res = doc.get("Resources") if isinstance(doc, dict) else None
    if isinstance(res, dict) and len(res) > cap:
        doc["Resources"] = dict(list(res.items())[:cap])
    return json.dumps(doc)


#: the control's cut: a document evaluated on its first 8 resources only
CONTROL_CAP = 8


def control_outcome_of(item: Tuple[str, str]) -> dict:
    """The control in the program's place: the reference with the
    guarantee that every document is evaluated whole broken, as a sweep
    that capped documents at a small node bucket would break it."""
    name, text = item
    return outcome(_RULES, name, truncated(text, CONTROL_CAP))
