"""The static analysis plane of the port: the plan/IR verifier and the
anchor signatures.

Copies of the JAX package's guard_tpu/analysis/{verify,signatures}.py,
reasoning about rules and compiled plans without touching a document or
a device:

  * ``verify``     — named-invariant checks over ``ops/plan.RulePlan``
                     structures (slot relocation, pack segments, bit
                     tables, anchor chains, rim coverage), hooked into
                     plan build / artifact load / per-bucket relocation;
  * ``signatures`` — per rule-file anchor key-chains and type
                     equalities, persisted with the plan artifact.

The rule linter (guard_tpu/analysis/lint.py) is not ported yet.
The per-run `--no-verify-plans` flag (`verify=False`) disables the
verifier hooks; validation output stays byte-identical
either way — the verifier can only *reject* a plan (hard diagnostic on
fresh lowering, logged miss on artifact load), never change what a
healthy plan computes.
"""

from __future__ import annotations

#: analysis-plane counters, under the JAX package's names:
#: `invariants_checked` counts individual invariant evaluations across
#: verify_plan/verify_relocation calls, `violations` the failures,
#: `lint_findings` the linter's findings (no linter in the port yet),
#: `signatures_extracted` per-file anchor signatures derived during
#: plan builds.
ANALYSIS_COUNTERS = {
    "invariants_checked": 0,
    "violations": 0,
    "lint_findings": 0,
    "signatures_extracted": 0,
}


def analysis_stats() -> dict:
    return dict(ANALYSIS_COUNTERS)


def reset_analysis_stats() -> None:
    for k in ANALYSIS_COUNTERS:
        ANALYSIS_COUNTERS[k] = 0
