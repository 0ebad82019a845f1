"""The `validate` path on the device: batch evaluation with oracle
reruns for the reports.

The port of the JAX package's `tpu_validate` (guard_tpu/ops/backend.py:
1695) and its report half (`_report_files`, `_finish_report`):

  1. encode the documents once (`_encode_docs`: the quarantine encode
     under --max-doc-failures, else the ingest pool, else the native
     encoder in process, else the tree encoder), lower every rule file
     up front through the plan layer (ops/plan.py: the in-process memo,
     the disk artifact, else a build), and relocate the shared encode
     into the plan's id namespace; files with function variables get
     their function results precomputed on the host by the CPU
     evaluator (ops/fnvars.precompute_fn_values) and encoded with each
     document into the plan's interner, so the walk's StepFnVar arm
     selects them on the device. Document trees are built only where
     something walks them (`_docs_for`);
  2. evaluate on the device: the files that can share the shared
     encode's program are fused into packs (`plan_packs`, one walk and
     one rim reduction (K3) per (pack, bucket); every (pack, bucket) is
     dispatched before any is collected), and each pack's statuses,
     unsure bits and rim blocks are sliced back per file; the other
     files (function variables, no device rule, a singleton pack,
     --no-pack) evaluate bucket by bucket on their own, K3 behind each
     walk. A packed dispatch or collect that raises a GuardError (an
     injected `dispatch`/`collect` fault, a GUARD_TPU_DISPATCH_TIMEOUT
     timeout) reruns per file for that bucket on the device, and a
     failed rerun ends the run. On the per-file path an injected fault
     sends its bucket to the host oracle, as in the JAX package; a
     timeout, and any other error, ends the run;
  3. pass A: whole-corpus masks over the rim blocks (`rim_masks`) pick
     the documents whose report needs the oracle (failures unless
     --statuses-only, unsure bits, documents the device did not
     evaluate, host rules, rich output) and those whose per-rule
     statuses must be built at all;
  4. the reruns: the native C++ oracle (ops/native_oracle.py) where it
     is built and accepts the rules, else the CPU evaluator
     (core/evaluator.py), over a spawn pool (ops/oracle_pool.py) when
     there are enough of them;
  5. pass B: every (rules file, document) pair's report in order, the
     documents pass A settled from one shared template per distinct
     status row; then the structured outputs and the exit code.

A device status that differs from the oracle's where no unsure bit was
set is an error (the `TPU/native` and `TPU/CPU` nets, as the JAX
package words them). A quarantined document stands in as `null` and
is left out of every report. The JAX package's result cache and scalar
rim are not ported: pass B walks the documents in order and is where
each would slot in.
"""

from __future__ import annotations

import logging
import os
import time
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..commands.report import rule_statuses_from_root, simplified_report_from_root
from ..core.errors import GuardError
from ..core.evaluator import eval_rules_file
from ..core.qresult import Status
from ..core.scopes import RootScope
from ..core.values import PV
from ..core.values import Path as VPath
from ..utils.faults import FAULT_COUNTERS, bounded_call, maybe_fail
from ..utils.io import Writer
from .encoder import Interner, encode_bucketed
from .fnvars import precompute_fn_values, precomputable_fn_vars
from .ir import (
    FAIL,
    PASS,
    SKIP,
    CompiledRules,
    PackIncompatible,
    build_rim_spec,
    compile_rules_file,
    name_groups,
    pack_compatible,
    pack_compiled,
)
from ..parallel.device import (
    EFFICIENCY_COUNTERS,
    DeviceBatchEvaluator,
    evaluate_groups,
    resolve_device,
)

log = logging.getLogger("guard_tpu_torch.backend")

# rule-packing ceiling: packs close when their rule count would exceed
# this (the 249 corpus files' 253 packable rules fit in one pack)
PACK_MAX_RULES = 512

STATUS = {PASS: Status.PASS, FAIL: Status.FAIL, SKIP: Status.SKIP}

# the counters of a report run (Evaluation.reruns)
RERUN_KEYS = (
    "materialized",  # (file, doc) pairs whose per-rule statuses were built
    "settled",  # pairs reported from a shared status-row template
    "native_statuses",  # pairs the native statuses prefilter settled
    "native_declines",  # prefilter calls the native oracle declined
    "native_reports",  # reports the native oracle built
    "pooled",  # CPU-evaluator reruns in the spawn pool
    "inline",  # CPU-evaluator reruns in this process
    "pool_failures",  # pools that could not start (reruns went inline)
)


@dataclass
class FileResult:
    """One rules file's device evaluation over the whole batch."""

    rule_file: object  # commands.validate.RuleFile
    compiled: CompiledRules
    statuses: np.ndarray  # (D, R) int8
    unsure: np.ndarray  # (D, R) bool
    rim: tuple  # six (D, ...) blocks, kernels.rim_reduce order
    names: List[str]  # name groups, declaration order
    # documents the device did not evaluate: beyond the last bucket,
    # exotic numbers, a raising function, a lost per-origin result
    host_docs: set = field(default_factory=set)
    # the per-bucket groups this file was evaluated on: the shared ones,
    # or its own when its function results were encoded with the docs
    groups: Optional[list] = None
    # the position of the pack this file was evaluated in
    # (Evaluation.packs), None when it was evaluated on its own
    pack: Optional[int] = None


@dataclass
class Evaluation:
    # [(bucket DocBatch, doc indices)] of the shared encode; None when
    # no file used it (every file with guard rules has function
    # variables and its own groups)
    groups: Optional[list]
    n_docs: int
    interner: Interner
    files: List[FileResult]
    device: torch.device
    # host clock seconds per phase: load (document trees built for the
    # tree encoder of the shared encode), encode (the shared encode's
    # wall, the ingest pool's included, and the per-file encodes of
    # files with function variables), merge (the ingest pool's shard
    # merge, inside encode), fn_precompute (the function values),
    # lower, device (ends when the last bucket is collected); and of the
    # report run: native (native oracle calls), pool (the spawn pool's
    # wall), inline (reruns in this process) and report (the rest:
    # passes A and B and the structured output)
    seconds: Dict[str, float] = field(default_factory=dict)
    # (rules file, document) pairs rerun on the CPU evaluator
    oracle_docs: int = 0
    # the report run's counters, RERUN_KEYS
    reruns: Dict[str, int] = field(default_factory=lambda: dict.fromkeys(RERUN_KEYS, 0))
    # how the shared encode ran (_encode_docs): path "quarantine",
    # "pool", "native" or "tree" (None when no file used it), the
    # ingest workers, and the pool's stats
    ingest: dict = field(default_factory=dict)
    # the member file positions of each pack evaluated
    packs: List[tuple] = field(default_factory=list)


def rim_masks(any_fail, any_unsure, host_mask, has_host_rules: bool,
              rich_mode: bool, statuses_only: bool, show_rich: bool = False):
    """Whole-corpus pass A over the rim blocks, as in the JAX package's
    backend: need_oracle (docs whose answer needs an oracle visit),
    needs_statuses (the subset whose statuses themselves are missing,
    where the native statuses prefilter applies) and materialize (docs
    whose per-rule dict is built at all; the rest settle from a shared
    template)."""
    base = bool(has_host_rules) or bool(rich_mode)
    need_oracle = any_unsure | host_mask
    if base:
        need_oracle = need_oracle | np.True_
    if not statuses_only:
        need_oracle = need_oracle | any_fail
    needs_statuses = any_unsure | host_mask
    if has_host_rules:
        needs_statuses = needs_statuses | np.True_
    materialize = need_oracle | any_fail
    if show_rich:
        materialize = materialize | np.True_
    return need_oracle, needs_statuses, materialize


def _empty_rim(n_docs: int) -> tuple:
    """The rim blocks of a file with no device rule: no name group, and
    every document SKIP."""
    return (
        np.zeros((n_docs, 0), np.int8), np.zeros((n_docs, 0), bool),
        np.full((n_docs, 1), SKIP, np.int8), np.zeros((n_docs, 1), bool),
        np.zeros((n_docs, 1), bool), np.zeros((n_docs, 0), np.int8),
    )


def uses_shared_encode(rule_file) -> bool:
    """Whether a rules file is evaluated on the shared encode: it has
    guard rules and no function variable (those files encode on their
    own, with their function results)."""
    return bool(rule_file.rules.guard_rules) and not precomputable_fn_vars(rule_file.rules)


def plan_packs(items, max_rules: Optional[int] = None):
    """Greedy pack planner over [(file_idx, CompiledRules)] pairs
    already screened with ir.pack_compatible: packs fill in file order
    and close when the next file would push the pack past `max_rules`.
    File order is preserved so packed statuses slice back per file in
    the caller's order."""
    max_rules = PACK_MAX_RULES if max_rules is None else max_rules
    packs, cur, cur_rules = [], [], 0
    for fi, c in items:
        n = len(c.rules)
        if cur and cur_rules + n > max_rules:
            packs.append(cur)
            cur, cur_rules = [], 0
        cur.append((fi, c))
        cur_rules += n
    if cur:
        packs.append(cur)
    return packs


class PackPending:
    """In-flight state between `dispatch_packs` and `collect_packs`:
    per pack (pack, PackedRules, RimSpec, evaluator, handles), each
    handle (doc indices, bucket batch, dispatch handle or None when the
    dispatch failed), and the documents no bucket holds."""

    __slots__ = ("pending", "host_docs", "n_docs")

    def __init__(self, pending, host_docs, n_docs):
        self.pending = pending
        self.host_docs = host_docs
        self.n_docs = n_docs


def dispatch_packs(items, groups, n_docs: int, oversize=(), device=None,
                   prepacked=None) -> PackPending:
    """Dispatch half of the fused multi-rule-file path: pack the
    compatible compiled files (plan_packs; or `prepacked`, the plan
    layer's [(pack, PackedRules, RimSpec)], which skips planning and
    packing) and dispatch EVERY (pack, bucket) of the shared encode
    `groups` without collecting. `oversize` are the documents no bucket
    holds. A dispatch that raises a GuardError keeps its bucket (handle
    None) for collect_packs' ladder."""
    dev = resolve_device(device)
    planned = [] if prepacked is None else prepacked
    if prepacked is None and len(items) >= 2:
        for pack in plan_packs(items):
            if len(pack) < 2:
                continue  # a singleton pack gains nothing over per-file
            try:
                packed = pack_compiled([c for _, c in pack])
            except PackIncompatible as e:
                log.info("pack of %d files fell back to per-file: %s", len(pack), e)
                continue
            planned.append((pack, packed, packed.rim_spec()))
    pending = []
    # every pack's evaluator is built before the first dispatch
    for pack, packed, spec in planned:
        EFFICIENCY_COUNTERS["pack_rule_slots_used"] += len(packed.compiled.rules)
        EFFICIENCY_COUNTERS["pack_rule_slots_capacity"] += PACK_MAX_RULES
        ev = DeviceBatchEvaluator(packed.compiled, dev, rim_spec=spec)
        pending.append((pack, packed, spec, ev, []))
    for pack, _packed, _spec, ev, handles in pending:
        for sub, idx in groups:
            try:
                maybe_fail("dispatch")
                handles.append((idx, sub, ev.dispatch(sub)))
            except GuardError as e:
                log.warning("packed dispatch failed for a %d-doc bucket (%s); "
                            "will retry per-file at collect", len(idx), e)
                FAULT_COUNTERS["dispatch_fallbacks"] += 1
                handles.append((idx, sub, None))
    return PackPending(pending, {int(i) for i in oversize}, n_docs)


def collect_packs(pp: PackPending) -> dict:
    """Collect half: wait for every (pack, bucket) and slice the results
    back per file. Returns {file_idx: (statuses (D, R_f) int8, unsure
    (D, R_f) bool, host_docs set, rim)}, `rim` the file's six blocks in
    FileResult's shapes (doc status, any-fail and any-unsure as (D, 1)
    columns).

    The degradation ladder: a bucket whose dispatch or collect raised a
    GuardError (an injected fault or a timeout) reruns per file for that
    bucket on the device, and the rim blocks of the recovered bucket are
    recomputed from its recovered status rows by the pack's K3. Nothing
    goes to the host oracle: a per-file rerun that fails (a timeout, a
    kernel that does not build or launch, a CUDA error) ends the run.
    The JAX package sends such a file's documents to its host oracle;
    the port keeps every document it put on the device there."""
    results: dict = {}
    d = pp.n_docs
    for pack, packed, spec, ev, handles in pp.pending:
        n_rules = len(packed.compiled.rules)
        statuses = np.full((d, n_rules), SKIP, np.int8)
        unsure = np.zeros((d, n_rules), bool)
        rim = [
            np.full((d, w), fill, dt) for w, fill, dt in (
                (spec.n_groups, SKIP, np.int8), (spec.n_groups, False, bool),
                (spec.n_files, SKIP, np.int8), (spec.n_files, False, bool),
                (spec.n_files, False, bool), (spec.n_groups, SKIP, np.int8),
            )
        ]
        for idx, sub, handle in handles:
            if handle is not None:
                try:
                    maybe_fail("collect")
                    st, un, blocks = bounded_call(ev.collect, handle)
                except GuardError as e:
                    log.warning("packed collect failed for a %d-doc bucket (%s); "
                                "retrying per-file", len(idx), e)
                    FAULT_COUNTERS["dispatch_fallbacks"] += 1
                else:
                    statuses[idx] = st
                    if un is not None:
                        unsure[idx] = un
                    for b, block in enumerate(blocks):
                        rim[b][idx] = block
                    continue
            # rung 2: per file for just this bucket, on the same device;
            # a failure here (a timeout among them) ends the run
            for k, (_fi, c) in enumerate(pack):
                seg = packed.segment(k)
                ev2 = DeviceBatchEvaluator(c, ev.device)
                st, un = bounded_call(lambda: ev2.collect(ev2.dispatch(sub)))
                statuses[idx, seg] = st
                if un is not None:
                    unsure[idx, seg] = un
            for b, block in enumerate(ev.rim_of(statuses[idx], unsure[idx])):
                rim[b][idx] = block
        for k, (fi, _c) in enumerate(pack):
            seg = packed.segment(k)
            gsl = spec.file_slice(k)
            fsl = slice(k, k + 1)
            blocks_f = (rim[0][:, gsl], rim[1][:, gsl], rim[2][:, fsl],
                        rim[3][:, fsl], rim[4][:, fsl], rim[5][:, gsl])
            results[fi] = (statuses[:, seg], unsure[:, seg],
                           set(pp.host_docs), blocks_f)
    return results


def _evaluate_packs(items, groups, n_docs: int, oversize=(), device=None,
                    prepacked=None) -> dict:
    """dispatch_packs + collect_packs: every (pack, bucket) dispatches
    before anything collects."""
    return collect_packs(dispatch_packs(items, groups, n_docs, oversize, device, prepacked))


def evaluate(rule_files, docs, device=None, shared=None, pack_rules: bool = True,
             plan_cache: bool = True, verify_plans: bool = True) -> Evaluation:
    """Lower every rules file and evaluate it on `device` (CUDA unless
    given). `docs` are the documents' PV trees (a sequence that may
    build them on access). `shared` is the shared encode, (groups,
    oversize, interner) as encoder.encode_bucketed returns them, when
    the caller has it; else it is encoded from `docs` when a file uses
    it (uses_shared_encode).

    With the plan layer on (`plan_cache`) the
    files are lowered through ops/plan.get_plan and the shared encode is
    relocated into the plan's interner (`verify_plans` runs the
    analysis plane's invariants there); otherwise each file is lowered
    against the shared encode's interner. With packing on (`pack_rules`)
    the files on the shared encode evaluate as packs.
    Files with function variables get their function values precomputed
    and are encoded on their own, into the same interner."""
    from .plan import get_plan, relocate_batch

    dev = resolve_device(device)
    seconds = {"fn_precompute": 0.0, "encode": 0.0}
    if shared is not None:
        interner = shared[2]
        shared = (shared[0], {int(i) for i in shared[1]})
    else:
        interner = Interner()
    if shared is None and any(uses_shared_encode(rf) for rf in rule_files):
        t1 = time.perf_counter()
        groups, oversize, _ = encode_bucketed(docs, interner)
        shared = (groups, {int(i) for i in oversize})
        seconds["encode"] += time.perf_counter() - t1

    t0 = time.perf_counter()
    shared_encode_s = seconds["encode"]
    plan = None
    if plan_cache:
        plan = get_plan(rule_files, verify=verify_plans, device=dev)
        if shared is not None:
            relocate_batch(plan, [b for b, _ in shared[0]], interner, verify=verify_plans)
        interner = plan.interner
    lowered = []
    for fi, rf in enumerate(rule_files):
        f_groups, f_host = None, set()
        compiled = None if plan is None else plan.compiled[fi]
        if precomputable_fn_vars(rf.rules):
            t1 = time.perf_counter()
            fn_vars, fn_vals, fn_err = precompute_fn_values(rf.rules, docs)
            seconds["fn_precompute"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            f_groups, f_oversize, _ = encode_bucketed(
                docs, interner, fn_values=fn_vals, fn_var_order=fn_vars
            )
            seconds["encode"] += time.perf_counter() - t1
            # a function raised on these documents: the oracle reruns
            # them and reproduces the error
            f_host = {int(i) for i in f_oversize} | set(fn_err)
            compiled = None  # lowered after its own encode
        elif uses_shared_encode(rf):
            f_groups, f_host = shared[0], set(shared[1])
        if compiled is None:
            compiled = compile_rules_file(rf.rules, interner)
        lowered.append((rf, compiled, f_groups, f_host))

    seconds["lower"] = (
        time.perf_counter() - t0 - seconds["fn_precompute"]
        - (seconds["encode"] - shared_encode_s)
    )

    t0 = time.perf_counter()
    d = len(docs)
    packed_results: dict = {}
    pack_members: List[tuple] = []
    if pack_rules and shared is not None:
        items = [
            (fi, c) for fi, (_rf, c, g, _h) in enumerate(lowered)
            if g is shared[0] and pack_compatible(c) is None
        ]
        pending = dispatch_packs(
            items, shared[0], d, shared[1], dev,
            prepacked=plan.prepacked_items() if plan is not None else None,
        )
        pack_members = [tuple(fi for fi, _c in pack) for pack, *_ in pending.pending]
        packed_results = collect_packs(pending)
    pack_of = {fi: p for p, members in enumerate(pack_members) for fi in members}
    files = []
    for fi, (rf, compiled, f_groups, f_host) in enumerate(lowered):
        if fi in packed_results:
            statuses, unsure, host, rim = packed_results[fi]
            files.append(FileResult(rf, compiled, statuses, unsure, rim,
                                    name_groups(compiled.rules)[1], host, f_groups,
                                    pack_of[fi]))
            continue
        if not compiled.rules:
            st = np.zeros((d, 0), np.int8)
            un = np.zeros((d, 0), bool)
            files.append(FileResult(rf, compiled, st, un, _empty_rim(d), [],
                                    f_host, f_groups))
            continue
        spec = build_rim_spec([compiled.rules])
        ev = DeviceBatchEvaluator(compiled, dev, rim_spec=spec)
        # documents outside f_groups are left SKIP by evaluate_groups
        statuses, unsure, host, rim = evaluate_groups(
            ev, len(compiled.rules), f_groups, (), d
        )
        files.append(FileResult(rf, compiled, statuses, unsure, rim,
                                spec.file_group_names[0], f_host | host, f_groups))
    seconds["device"] = time.perf_counter() - t0
    return Evaluation(None if shared is None else shared[0], d, interner, files,
                      dev, seconds, packs=pack_members)


def _materialize_row(name_row, unsure_row, names):
    """One doc's (rule_statuses dict, unsure_rules set) from its rim
    row, in declaration order (the summary table prints that order)."""
    rule_statuses = {}
    unsure_rules = set()
    for g, name in enumerate(names):
        rule_statuses[name] = STATUS[int(name_row[g])]
        if unsure_row is not None and bool(unsure_row[g]):
            unsure_rules.add(name)
    return rule_statuses, unsure_rules


def _status_fields(rule_statuses: Dict[str, Status]) -> dict:
    """The rule lists of a report without clause detail: failing rules
    without checks, as the JAX package builds them."""
    return {
        "not_compliant": [
            {
                "Rule": {
                    "name": n,
                    "metadata": {},
                    "messages": {"custom_message": None, "error_message": None},
                    "checks": [],
                }
            }
            for n, s in sorted(rule_statuses.items())
            if s == Status.FAIL
        ],
        "not_applicable": sorted(
            n for n, s in rule_statuses.items() if s == Status.SKIP
        ),
        "compliant": sorted(
            n for n, s in rule_statuses.items() if s == Status.PASS
        ),
    }


def _settled_template(name_row, names):
    """What every doc with this status row shares: the report's status
    and rule lists, the rule_statuses dict and the doc status. Built
    once per distinct row; a settled doc's report is a thin dict
    around the shared lists."""
    rule_statuses, _ = _materialize_row(name_row, None, names)
    vals = list(rule_statuses.values())
    if Status.FAIL in vals:
        status = Status.FAIL
    elif Status.PASS in vals:
        status = Status.PASS
    else:
        status = Status.SKIP
    fields = {"status": status.value, **_status_fields(rule_statuses)}
    return fields, rule_statuses, status


def _check_parity(rule_statuses, other, unsure_rules, data_file, label: str) -> None:
    """A device status must equal the oracle's, except on rules the
    device flagged unsure (the oracle's answer stands there)."""
    for rn, st in rule_statuses.items():
        ost = other.get(rn)
        if ost is not None and ost != st and rn not in unsure_rules:
            raise GuardError(
                f"TPU/{label} status divergence for rule {rn} on "
                f"{data_file.name}: tpu={st.value} {label.lower()}={ost.value}"
            )


class _ReportAcc:
    """One run's report accumulators: the error count, whether any doc
    failed, every materialized report (structured output) and the JUnit
    cases per document (no suite for a quarantined one)."""

    __slots__ = ("errors", "had_fail", "all_reports", "junit_suites")

    def __init__(self, data_files, quarantined):
        self.errors = 0
        self.had_fail = False
        self.all_reports: List[dict] = []
        self.junit_suites = {
            df.name: [] for di, df in enumerate(data_files) if di not in quarantined
        }


def _report_files(validate, evaluation: Evaluation, data_files, quarantined,
                  writer: Writer, acc: _ReportAcc) -> None:
    """Report half of the device path, one iteration per rules file:
    pass A (which docs need the oracle), the native, pooled and inline
    reruns, and pass B (report emission in document order). Quarantined
    documents are neither rerun nor reported."""
    from ..commands.reporters.aware import console_chain
    from ..commands.reporters.junit import JunitTestCase, failure_info_from_report
    from ..commands.validate import _looks_json
    from .native_oracle import (
        NativeEvalError,
        NativeOracle,
        NativeUnsupported,
        overall_status,
    )
    from .oracle_pool import POOL_MAX_WORKERS, POOL_MIN_JOBS, run_oracle_jobs

    counts = evaluation.reruns
    secs = evaluation.seconds
    for key in ("native", "pool", "inline"):
        secs.setdefault(key, 0.0)
    statuses_only = bool(validate.statuses_only)
    # the verbose tree and print-json need the CPU evaluator's record
    # tree: the native oracle stays off for them, as in the JAX package
    rich_tree = validate.verbose or validate.print_json
    rich_mode = validate.structured or rich_tree
    show_rich = bool({"pass", "skip", "all"} & set(validate.show_summary))
    raw_allowed = not validate.input_params
    D = len(data_files)

    for fr in evaluation.files:
        rule_file = fr.rule_file
        native = None
        if not rich_tree:
            try:
                native = NativeOracle(rule_file.rules)
            except NativeUnsupported:
                native = None
        guard_rule_names = [r.rule_name for r in rule_file.rules.guard_rules]

        def _merge_native(raw_statuses):
            """Same-name merge as the report layer (non-SKIP beats
            SKIP, FAIL dominates)."""
            merged = {}
            for name, s in zip(guard_rule_names, raw_statuses):
                st = STATUS[s]
                prev = merged.get(name)
                if prev is None or (prev == Status.SKIP and st != Status.SKIP):
                    merged[name] = st
                elif st == Status.FAIL:
                    merged[name] = Status.FAIL
            return merged

        def _native_prefilter(data_file):
            """The native statuses of one doc: (merged statuses,
            overall) or None on a decline."""
            t0 = time.perf_counter()
            raw = None
            try:
                if raw_allowed and _looks_json(data_file.content):
                    try:
                        raw = native.eval_raw_json(data_file.content)
                    except (NativeUnsupported, NativeEvalError):
                        # e.g. flow-style YAML that sniffs as JSON, or a
                        # decline: the loaded tree is authoritative
                        raw = None
                if raw is None:
                    try:
                        raw = native.eval_doc(data_file.path_value)
                    except (NativeUnsupported, NativeEvalError):
                        raw = None
            finally:
                secs["native"] += time.perf_counter() - t0
            if raw is None:
                return None
            return (_merge_native(raw), STATUS[overall_status(raw)])

        def _native_report(data_file):
            """(report, statuses, status) from the native oracle, or
            None when it declines or errs (the CPU evaluator then
            reproduces a genuine error)."""
            t0 = time.perf_counter()
            try:
                if raw_allowed and _looks_json(data_file.content):
                    try:
                        return native.eval_report_raw(data_file.content, data_file.name)
                    except (NativeUnsupported, NativeEvalError):
                        # possibly flow-style YAML sniffing as JSON:
                        # retry from the loaded tree before giving up
                        pass
                try:
                    return native.eval_report(data_file.path_value, data_file.name)
                except (NativeUnsupported, NativeEvalError):
                    return None
            finally:
                secs["native"] += time.perf_counter() - t0

        # -- pass A: whole-corpus masks over the rim blocks ------------
        name_st, name_un, doc_st, any_fail, any_un, _last = fr.rim
        names = fr.names
        host_mask = np.zeros(D, bool)
        host_mask[sorted(hd for hd in fr.host_docs if hd < D)] = True
        need_oracle_v, needs_statuses_v, materialize_v = rim_masks(
            any_fail[:, 0], any_un[:, 0], host_mask, bool(fr.compiled.host_rules),
            rich_mode, statuses_only, show_rich,
        )
        if quarantined:
            qmask = np.zeros(D, bool)
            qmask[list(quarantined)] = True
            need_oracle_v &= ~qmask
            materialize_v &= ~qmask
        prefilter_v = need_oracle_v & (needs_statuses_v | statuses_only)
        doc_infos: dict = {}
        oracle_dis = []
        native_declines = 0
        for di in np.nonzero(materialize_v)[0]:
            di = int(di)
            data_file = data_files[di]
            if not host_mask[di]:
                rule_statuses, unsure_rules = _materialize_row(
                    name_st[di], name_un[di], names
                )
                doc_status = STATUS[int(doc_st[di, 0])]
            else:
                rule_statuses, unsure_rules = {}, set()
                doc_status = Status.SKIP
            counts["materialized"] += 1
            need_oracle = bool(need_oracle_v[di])
            native_statuses = None
            if need_oracle and native is not None and prefilter_v[di]:
                native_statuses = _native_prefilter(data_file)
                if native_statuses is not None:
                    if statuses_only or native_statuses[1] != Status.FAIL:
                        # statuses suffice: no rich rerun
                        need_oracle = False
                        counts["native_statuses"] += 1
                else:
                    native_declines += 1
            doc_infos[di] = (rule_statuses, unsure_rules, doc_status, native_statuses)
            if need_oracle:
                oracle_dis.append(di)
        counts["settled"] += int(D - materialize_v.sum())
        counts["native_declines"] += native_declines

        # -- the reruns: a spawn pool when there are enough ------------
        # workers rebuild documents from raw content, so merged
        # --input-params documents keep the inline path
        pooled_results = {}
        if (
            (native is None or native_declines >= POOL_MIN_JOBS)
            and len(oracle_dis) >= POOL_MIN_JOBS
            and not validate.input_params
        ):
            workers = min(len(oracle_dis), os.cpu_count() or 1, POOL_MAX_WORKERS)
            if workers > 1:
                jobs = [
                    (0, di, data_files[di].name, data_files[di].content)
                    for di in oracle_dis
                ]
                t0 = time.perf_counter()
                try:
                    pooled_results = run_oracle_jobs(0, rule_file, jobs, workers)
                except Exception as e:
                    # a pool can fail to start (an embedder's unguarded
                    # __main__ re-executed under spawn): the inline
                    # path is always safe, and the failure is counted
                    log.warning(
                        "oracle rerun pool unavailable (%s); falling back "
                        "to inline reruns", e,
                    )
                    counts["pool_failures"] += 1
                    pooled_results = {}
                secs["pool"] += time.perf_counter() - t0

        # -- pass B: every pair's report, in document order ------------
        # settled docs take their report from the shared per-row
        # template and never enter the JUnit or structured accumulators
        # (a run that emits those materializes every doc)
        oracle_set = set(oracle_dis)
        row_cache: dict = {}
        for di, data_file in enumerate(data_files):
            if di in quarantined:
                continue
            if di not in doc_infos:
                key = name_st[di].tobytes()
                cached = row_cache.get(key)
                if cached is None:
                    cached = row_cache[key] = _settled_template(name_st[di], names)
                fields, rule_statuses, doc_status = cached
                if doc_status == Status.FAIL:
                    acc.had_fail = True
                if not validate.structured:
                    report = {"name": data_file.name, "metadata": {}, **fields}
                    console_chain(
                        writer, data_file.name, data_file.content, data_file,
                        rule_file.name, doc_status, rule_statuses, report,
                        validate.show_summary, validate.output_format,
                    )
                continue
            rule_statuses, unsure_rules, doc_status, native_statuses = doc_infos[di]
            need_oracle = di in oracle_set
            if native_statuses is not None and not need_oracle:
                merged, n_doc_status = native_statuses
                _check_parity(rule_statuses, merged, unsure_rules, data_file, "native")
                rule_statuses = merged
                doc_status = n_doc_status
            report = {
                "name": data_file.name,
                "metadata": {},
                "status": doc_status.value,
                **_status_fields(rule_statuses),
            }
            if need_oracle and native is not None and di not in pooled_results:
                # the native report equals simplified_report_from_root
                # over the CPU evaluator's tree
                native_result = _native_report(data_file)
                if native_result is not None:
                    report, oracle_rule_statuses, oracle_status = native_result
                    counts["native_reports"] += 1
                    _check_parity(rule_statuses, oracle_rule_statuses, unsure_rules,
                                  data_file, "native")
                    rule_statuses = oracle_rule_statuses
                    doc_status = oracle_status
                    need_oracle = False
            if need_oracle:
                if di in pooled_results:
                    _key, st_val, p_report, p_statuses, err = pooled_results[di]
                    counts["pooled"] += 1
                    evaluation.oracle_docs += 1
                    if err is not None:
                        writer.writeln_err(err)
                        acc.errors += 1
                        continue
                    oracle_status = Status(st_val)
                    report = p_report
                    oracle_rule_statuses = {n: Status(v) for n, v in p_statuses.items()}
                else:
                    counts["inline"] += 1
                    evaluation.oracle_docs += 1
                    t0 = time.perf_counter()
                    try:
                        maybe_fail("oracle", key=data_file.name)
                        scope = RootScope(rule_file.rules, data_file.path_value)
                        oracle_status = eval_rules_file(
                            rule_file.rules, scope, data_file.name
                        )
                    except GuardError as e:
                        writer.writeln_err(str(e))
                        acc.errors += 1
                        continue
                    finally:
                        secs["inline"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    root_record = scope.reset_recorder().extract()
                    report = simplified_report_from_root(root_record, data_file.name)
                    oracle_rule_statuses = rule_statuses_from_root(root_record)
                    secs["inline"] += time.perf_counter() - t0
                _check_parity(rule_statuses, oracle_rule_statuses, unsure_rules,
                              data_file, "CPU")
                rule_statuses = oracle_rule_statuses
                doc_status = oracle_status

            if doc_status == Status.FAIL:
                acc.had_fail = True
            acc.all_reports.append(report)
            fname, fmsgs = failure_info_from_report(report)
            acc.junit_suites[data_file.name].append(
                JunitTestCase(
                    name=rule_file.name,
                    status=doc_status,
                    failure_name=fname if doc_status == Status.FAIL else None,
                    failure_messages=fmsgs if doc_status == Status.FAIL else None,
                )
            )
            if not validate.structured:
                console_chain(
                    writer, data_file.name, data_file.content, data_file,
                    rule_file.name, doc_status, rule_statuses, report,
                    validate.show_summary, validate.output_format,
                )

        if native is not None:
            native.close()


def _finish_report(validate, acc: _ReportAcc, writer: Writer, quarantined,
                   max_df) -> int:
    """Structured-output emission and the exit code: an error wins, then
    more quarantined documents than --max-doc-failures allows (a
    negative limit allows any number), then a failing document."""
    from ..commands.reporters.junit import write_junit
    from ..commands.reporters.sarif import write_sarif
    from ..commands.reporters.structured import write_structured
    from ..commands.validate import (
        ERROR_STATUS_CODE,
        FAILURE_STATUS_CODE,
        SUCCESS_STATUS_CODE,
    )

    if validate.structured:
        if validate.output_format in ("json", "yaml"):
            write_structured(writer, acc.all_reports, validate.output_format)
        elif validate.output_format == "sarif":
            write_sarif(writer, acc.all_reports)
        elif validate.output_format == "junit":
            write_junit(writer, acc.junit_suites)
    if acc.errors > 0:
        return ERROR_STATUS_CODE
    if quarantined:
        FAULT_COUNTERS["quarantined_docs"] += len(quarantined)
        if max_df is not None and 0 <= max_df < len(quarantined):
            return ERROR_STATUS_CODE
    if acc.had_fail:
        return FAILURE_STATUS_CODE
    return SUCCESS_STATUS_CODE


class _DocTrees(Sequence):
    """The documents' PV trees, each built on first access
    (DataFile.path_value) and kept by its DataFile; a quarantined
    document stands in as `null`, so the geometry stays aligned."""

    def __init__(self, data_files, quarantined):
        self._files = data_files
        self._quarantined = quarantined

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, i):
        if i in self._quarantined:
            return PV.null(VPath.root())
        return self._files[i].path_value


def _docs_for(data_files, quarantined):
    """Python document trees, built lazily: on all-JSON corpora the
    native encoder, the device kernels and the native oracle run from
    raw content, and a tree is paid for only by the documents something
    walks (function-variable precompute, the tree encoder, CPU-oracle
    reruns in this process, the console's attribution of failures).
    Quarantined documents stand in as `null`."""
    return _DocTrees(data_files, quarantined)


def _encode_docs(validate, data_files, writer: Writer, seconds: dict):
    """The shared encode, as the JAX package's `_encode_docs`: the
    quarantine encode under --max-doc-failures, else the ingest pool
    (two or more workers, not for payloads or --input-params), else the
    native encoder in this process when every document sniffs as JSON,
    there are no --input-params (their merged trees are the documents)
    and the library is built, else the tree encoder. Returns (shared,
    quarantined, ingest): shared = (groups, oversize, interner) as
    encoder.encode_bucketed returns them, `quarantined` maps a document
    index to its failure record (empty outside --max-doc-failures), and
    `ingest` says which path ran. Sets seconds["encode"], and
    seconds["load"] and seconds["merge"] where they apply."""
    from ..commands.validate import _looks_json
    from ..parallel.ingest import parallel_encode_documents, resolve_ingest_workers
    from .encoder import encode_chunk_texts
    from .native_encoder import encode_json_bucketed, native_available

    t0 = time.perf_counter()
    names = [df.name for df in data_files]
    contents = [df.content for df in data_files]
    quarantined: dict = {}
    workers = resolve_ingest_workers(validate.ingest_workers)
    ingest = {"path": None, "workers": workers}
    shared = None
    if validate.max_doc_failures is not None and not validate.input_params:
        (groups, oversize, interner, q_order, q_msgs, _q_err, q_records,
         q_pvs) = encode_chunk_texts(names, contents)
        shared = (groups, oversize, interner)
        quarantined = dict(zip(q_order, q_records))
        for m in q_msgs:
            writer.writeln_err(m)
        if q_pvs is not None:
            for df, pv in zip(data_files, q_pvs):
                if pv is not None and df._pv is None:
                    df._pv = pv
        ingest["path"] = "quarantine"
    if (
        shared is None
        and workers >= 2
        and len(data_files) >= 2
        and not validate.payload
        and not validate.input_params
    ):
        got = parallel_encode_documents(names, contents, workers)
        if got is not None:
            shared = got[:3]
            ingest.update(path="pool", stats=got[3])
            seconds["merge"] = got[3]["merge_s"]
    if (
        shared is None
        and not validate.input_params
        and all(_looks_json(c) for c in contents)
        and native_available()
    ):
        groups, oversize, interner, err = encode_json_bucketed(contents)
        if err is None:
            shared = (groups, oversize, interner)
            ingest["path"] = "native"
    if shared is None:
        t1 = time.perf_counter()
        docs = list(_docs_for(data_files, quarantined))
        seconds["load"] = time.perf_counter() - t1
        shared = encode_bucketed(docs)
        ingest["path"] = "tree"
    seconds["encode"] = time.perf_counter() - t0 - seconds.get("load", 0.0)
    return shared, quarantined, ingest


def tpu_validate(validate, rule_files, data_files, writer: Writer) -> int:
    """Drop-in body of Validate.execute on the device: encode the
    documents (the shared encode only when a file uses it, or under
    --max-doc-failures), evaluate, then report (full reports, or rule
    statuses alone under --statuses-only)."""
    from ..commands.validate import SUCCESS_STATUS_CODE

    if not data_files or not rule_files:
        return SUCCESS_STATUS_CODE
    seconds = {"load": 0.0}
    shared, quarantined, ingest = None, {}, {"path": None}
    if validate.max_doc_failures is not None or any(
        uses_shared_encode(rf) for rf in rule_files
    ):
        shared, quarantined, ingest = _encode_docs(validate, data_files, writer, seconds)
    else:
        # every tree, in document order, as the JAX package's encode
        # builds them: a document that does not load stops the run here
        t0 = time.perf_counter()
        for df in data_files:
            df.path_value
        seconds["load"] = time.perf_counter() - t0
    evaluation = evaluate(
        rule_files, _docs_for(data_files, quarantined), validate.device, shared=shared,
        pack_rules=validate.pack_rules, plan_cache=validate.plan_cache,
        verify_plans=validate.verify_plans,
    )
    evaluation.seconds["encode"] += seconds.pop("encode", 0.0)
    evaluation.seconds.update(seconds)
    evaluation.ingest = ingest
    validate.last_evaluation = evaluation
    t0 = time.perf_counter()
    acc = _ReportAcc(data_files, quarantined)
    try:
        _report_files(validate, evaluation, data_files, quarantined, writer, acc)
        return _finish_report(validate, acc, writer, quarantined, validate.max_doc_failures)
    finally:
        secs = evaluation.seconds
        secs["report"] = (
            time.perf_counter() - t0 - secs["native"] - secs["pool"] - secs["inline"]
        )
