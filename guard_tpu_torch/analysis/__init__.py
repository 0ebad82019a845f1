"""The static analysis plane of the port: the plan/IR verifier, the
anchor signatures and the rule linter.

Copies of the JAX package's guard_tpu/analysis/{verify,signatures,lint}.py,
reasoning about rules and compiled plans without touching a document or
a device:

  * ``verify``     — named-invariant checks over ``ops/plan.RulePlan``
                     structures (slot relocation, pack segments, bit
                     tables, anchor chains, rim coverage), hooked into
                     plan build / artifact load / per-bucket relocation;
  * ``signatures`` — per rule-file anchor key-chains and type
                     equalities, persisted with the plan artifact;
  * ``lint``       — abstract-domain checks over parsed rules (the
                     `lint` command).

The per-run `--no-verify-plans` flag (`verify=False`) disables the
verifier hooks; validation output stays byte-identical
either way — the verifier can only *reject* a plan (hard diagnostic on
fresh lowering, logged miss on artifact load), never change what a
healthy plan computes.
"""

from __future__ import annotations

from ..utils.telemetry import REGISTRY as _TELEMETRY

#: analysis-plane counters, the telemetry group "analysis" under the
#: JAX package's names:
#: `invariants_checked` counts individual invariant evaluations across
#: verify_plan/verify_relocation calls, `violations` the failures,
#: `lint_findings` the linter's findings,
#: `signatures_extracted` per-file anchor signatures derived during
#: plan builds.
ANALYSIS_COUNTERS = _TELEMETRY.counter_group("analysis", {
    "invariants_checked": 0,
    "violations": 0,
    "lint_findings": 0,
    "signatures_extracted": 0,
})


def analysis_stats() -> dict:
    return _TELEMETRY.group_stats("analysis")


def reset_analysis_stats() -> None:
    _TELEMETRY.reset_group("analysis")
