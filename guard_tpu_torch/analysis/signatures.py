"""Anchor-signature extraction: what a rule file can ever match on.

Statically derives, per rule file, the set of ANCHORS a document must
exhibit for any rule in the file to get past its selection queries:

  * type equalities — `Resources.*.Type == 'AWS::X::Y'` shapes, the
    type-block sugar, and `Type IN [...]` filters; the classic
    cfn-guard anchoring idiom;
  * key chains — the leading run of literal map keys on each
    top-level rule query (`Resources`, `Resources.Outputs`, ...): a
    doc with no such key chain can only ever produce retrieval
    misses for that query.

The product (`PlanSignatures`) is persisted inside the plan artifact
(ops/plan.py, digest-versioned via PLAN_SCHEMA_VERSION) and as a
human-readable JSON sidecar next to it, with a pack -> union-signature
inverted index — the routing input `mesh2d.assign_columns` will
consume for rule-relevance partial evaluation (ROADMAP item 2):
"dispatch only packs with >= 1 potentially-matching doc".

Extraction is sound-for-routing, not complete: a rule whose anchors
cannot be derived (variable-headed queries, `this`, interpolation)
is counted in `unanchored_rules` — a file with any unanchored rule
must never be skipped by a router. Signatures never influence
evaluation today; byte parity is structural.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..core import values as _v
from ..core.exprs import (
    AccessQuery,
    BlockGuardClause,
    GuardAccessClause,
    QKey,
    Rule,
    RulesFile,
    TypeBlock,
    WhenBlockClause,
    part_is_variable,
    walk_expr_tree,
)
from ..core.values import PV
from . import ANALYSIS_COUNTERS

#: bump when the extracted shape changes — persisted inside the plan
#: artifact AND the JSON sidecar, so stale routers can reject
SIGNATURE_SCHEMA_VERSION = 1


@dataclass
class FileSignature:
    """One rule file's anchors. Empty lists + unanchored_rules == 0
    means the file genuinely anchors on nothing (e.g. pure named-rule
    composition) and a router must treat it as match-anything."""

    type_equalities: List[str] = field(default_factory=list)
    key_chains: List[Tuple[str, ...]] = field(default_factory=list)
    unanchored_rules: int = 0

    def to_json(self) -> dict:
        return {
            "type_equalities": list(self.type_equalities),
            "key_chains": [list(kc) for kc in self.key_chains],
            "unanchored_rules": self.unanchored_rules,
        }

    @staticmethod
    def from_json(doc: dict) -> "FileSignature":
        return FileSignature(
            type_equalities=list(doc.get("type_equalities", [])),
            key_chains=[tuple(kc) for kc in doc.get("key_chains", [])],
            unanchored_rules=int(doc.get("unanchored_rules", 0)),
        )


@dataclass
class PlanSignatures:
    """Per-file signatures in plan file-position order, plus the
    schema stamp. Pickled inside the RulePlan artifact; `pack_union`
    derives the inverted-index row for one pack's member set."""

    schema: int
    files: List[Optional[FileSignature]]

    def pack_union(self, member_positions) -> FileSignature:
        u = FileSignature()
        types: set = set()
        chains: set = set()
        for fi in member_positions:
            sig = self.files[fi] if 0 <= fi < len(self.files) else None
            if sig is None:
                u.unanchored_rules += 1
                continue
            types.update(sig.type_equalities)
            chains.update(sig.key_chains)
            u.unanchored_rules += sig.unanchored_rules
        u.type_equalities = sorted(types)
        u.key_chains = sorted(chains)
        return u


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------
def _string_values(lv) -> List[str]:
    """STRING literal(s) of a compare RHS: a bare string, or every
    string item of a list literal (`IN [...]`)."""
    if not isinstance(lv, PV):
        return []
    if lv.kind == _v.STRING:
        return [lv.val]
    if lv.kind == _v.LIST:
        return [it.val for it in lv.val if it.kind == _v.STRING]
    return []


def _leading_key_chain(query: List) -> Tuple[str, ...]:
    """The leading run of literal map keys on a root-anchored query —
    empty for variable/`this`-headed queries."""
    out: List[str] = []
    for part in query:
        if isinstance(part, QKey) and not part_is_variable(part):
            out.append(part.name)
        else:
            break
    return tuple(out)


def _type_equalities(obj) -> List[str]:
    """Every `... .Type == 'X'` / `Type IN [...]` anchor reachable in
    `obj` — including filter conjunctions (`Resources[ Type == 'X' ]`)
    and type-block sugar — via the structural AST walk."""
    found: List[str] = []

    def visit(node) -> bool:
        if isinstance(node, TypeBlock):
            found.append(node.type_name)
            return False
        if isinstance(node, GuardAccessClause):
            ac = node.access_clause
            if (
                not node.negation
                and not ac.comparator_inverse
                and ac.comparator.value in ("Eq", "In")
            ):
                parts = ac.query.query
                last_key = parts[-1] if parts else None
                if (
                    isinstance(last_key, QKey)
                    and not part_is_variable(last_key)
                    and last_key.name == "Type"
                ):
                    found.extend(_string_values(ac.compare_with))
        return False

    walk_expr_tree(obj, visit)
    return found


def _rule_anchors(rule: Rule):
    """(type_equalities, key_chains, anchored) for one named rule:
    key chains come from the rule's TOP-LEVEL clause queries only
    (inner block queries are relative, not root-anchored)."""
    types = _type_equalities(rule)
    chains: List[Tuple[str, ...]] = []
    anchored = False
    top: List = []
    for conj in (rule.conditions or []):
        top.extend(conj)
    for conj in rule.block.conjunctions:
        top.extend(conj)
    for clause in top:
        q: Optional[AccessQuery] = None
        if isinstance(clause, GuardAccessClause):
            q = clause.access_clause.query
        elif isinstance(clause, BlockGuardClause):
            q = clause.query
        elif isinstance(clause, TypeBlock):
            kc = _leading_key_chain(clause.query)
            if kc:
                chains.append(kc)
                anchored = True
            continue
        elif isinstance(clause, WhenBlockClause):
            # the when gate's own queries anchor the whole block
            for c2 in (x for conj in clause.conditions for x in conj):
                if isinstance(c2, GuardAccessClause):
                    kc = _leading_key_chain(c2.access_clause.query.query)
                    if kc:
                        chains.append(kc)
                        anchored = True
            continue
        if q is not None:
            kc = _leading_key_chain(q.query)
            if kc:
                chains.append(kc)
                anchored = True
    return types, chains, anchored or bool(types)


def extract_file_signature(rules_file: RulesFile) -> FileSignature:
    """Anchor signature of one parsed rule file."""
    types: set = set()
    chains: set = set()
    unanchored = 0
    rules = list(rules_file.guard_rules)
    rules.extend(pr.rule for pr in rules_file.parameterized_rules)
    for rule in rules:
        t, c, anchored = _rule_anchors(rule)
        types.update(t)
        chains.update(c)
        if not anchored:
            unanchored += 1
    sig = FileSignature(
        type_equalities=sorted(types),
        key_chains=sorted(chains),
        unanchored_rules=unanchored,
    )
    ANALYSIS_COUNTERS["signatures_extracted"] += 1
    return sig


def extract_plan_signatures(rule_files) -> PlanSignatures:
    """Per-file signatures for a registry, in plan file-position
    order. `rule_files` carry parsed ASTs on `.rules` (the
    commands/validate.RuleFile shape build_plan already consumes)."""
    files: List[Optional[FileSignature]] = []
    for rf in rule_files:
        try:
            files.append(extract_file_signature(rf.rules))
        except Exception:
            # extraction is advisory: an unextractable file is an
            # unanchored (never-skippable) one, not an error
            files.append(None)
    return PlanSignatures(schema=SIGNATURE_SCHEMA_VERSION, files=files)


def signatures_payload(plan, digest: str) -> dict:
    """The JSON sidecar body: per-file signatures plus the
    pack -> union-signature inverted index, keyed by the plan digest
    (digest-versioned: a registry edit changes the digest, so stale
    sidecars simply never match a live plan)."""
    sigs: Optional[PlanSignatures] = getattr(plan, "signatures", None)
    files = []
    if sigs is not None:
        files = [
            (None if s is None else s.to_json()) for s in sigs.files
        ]
    packs = []
    if sigs is not None:
        for pos, _packed, _spec in plan.packs:
            u = sigs.pack_union(pos)
            packs.append({"members": list(pos), **u.to_json()})
    return {
        "schema": SIGNATURE_SCHEMA_VERSION,
        "digest": digest,
        "files": files,
        "packs": packs,
    }
