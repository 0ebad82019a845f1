"""The statuses-only `validate` path on the device.

Shaped like the JAX package's `tpu_validate` (guard_tpu/ops/backend.py:
1695) under `--statuses-only`: encode the documents, lower every rule
file, evaluate each file bucket by bucket on the device with the rim
reductions behind it, mask the rim blocks (`rim_masks`), and report
each (rules file, document) pair from its merged rule statuses.

Rule files with function variables are lowered per file, as the JAX
package's `_lower_rules` does: the function results are precomputed on
the host by the CPU evaluator (ops/fnvars.precompute_fn_values) and
encoded with each document, so the walk's StepFnVar arm selects them
on the device.

The documents the device cannot decide are rerun on the CPU oracle
(core/evaluator.eval_rules_file), as the JAX package does under
--statuses-only: those with an unsure bit, those over the last node
bucket or with numbers that have no exact device encoding, those on
which a function raised or whose per-origin result lost its origin,
and every document of a file with host rules. A device status that
differs from the oracle's where no unsure bit was set is an error.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.errors import GuardError
from ..core.qresult import Status
from .encoder import Interner, encode_bucketed
from .fnvars import precompute_fn_values, precomputable_fn_vars
from .ir import FAIL, PASS, SKIP, CompiledRules, build_rim_spec, compile_rules_file
from ..parallel.device import DeviceBatchEvaluator, evaluate_groups, resolve_device

STATUS = {PASS: Status.PASS, FAIL: Status.FAIL, SKIP: Status.SKIP}


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


@dataclass
class Evaluation:
    groups: list  # [(bucket DocBatch, doc indices)], encode_bucketed
    n_docs: int
    interner: Interner
    files: List[FileResult]
    device: torch.device
    # host clock seconds per phase: load (parse the documents; set by
    # validate_statuses), encode (with the per-file encodes of files
    # with function variables), fn_precompute (their function values),
    # lower, device (ends when the last bucket is collected), oracle and
    # report (set by report)
    seconds: Dict[str, float] = field(default_factory=dict)
    # (rules file, document) pairs rerun on the CPU oracle by report
    oracle_docs: int = 0


def rim_masks(any_fail, any_unsure, host_mask, has_host_rules: bool,
              rich_mode: bool, statuses_only: bool, show_rich: bool = False):
    """Whole-corpus pass A over the rim blocks (need_oracle,
    needs_statuses, materialize), as in the JAX package's backend."""
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


def evaluate(rule_files, docs, device=None) -> Evaluation:
    """Encode `docs` (PV trees), lower every rules file and evaluate it
    on `device` (CUDA unless given). Files with function variables get
    their function values precomputed and are encoded on their own."""
    dev = resolve_device(device)
    seconds = {"fn_precompute": 0.0}
    t0 = time.perf_counter()
    groups, oversize, interner = encode_bucketed(docs)
    seconds["encode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fn_encode_s = 0.0
    lowered = []
    for rf in rule_files:
        f_groups, f_host = groups, {int(i) for i in oversize}
        if precomputable_fn_vars(rf.rules):
            t1 = time.perf_counter()
            fn_vars, fn_vals, fn_err = precompute_fn_values(rf.rules, docs)
            seconds["fn_precompute"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            f_groups, f_oversize, _ = encode_bucketed(
                docs, interner, fn_values=fn_vals, fn_var_order=fn_vars
            )
            fn_encode_s += time.perf_counter() - t1
            # a function raised on these documents: the oracle reruns
            # them and reproduces the error
            f_host = {int(i) for i in f_oversize} | set(fn_err)
        compiled = compile_rules_file(rf.rules, interner)
        ev = spec = None
        if compiled.rules:
            spec = build_rim_spec([compiled.rules])
            ev = DeviceBatchEvaluator(compiled, dev, rim_spec=spec)
        lowered.append((rf, compiled, ev, spec, f_groups, f_host))
    seconds["lower"] = (
        time.perf_counter() - t0 - seconds["fn_precompute"] - fn_encode_s
    )
    seconds["encode"] += fn_encode_s

    t0 = time.perf_counter()
    d = len(docs)
    files = []
    for rf, compiled, ev, spec, f_groups, f_host in lowered:
        if ev is None:
            st = np.zeros((d, 0), np.int8)
            un = np.zeros((d, 0), bool)
            files.append(FileResult(rf, compiled, st, un, _empty_rim(d), [],
                                    f_host, f_groups))
            continue
        # documents outside f_groups are left SKIP by evaluate_groups
        statuses, unsure, _host, rim = evaluate_groups(
            ev, len(compiled.rules), f_groups, (), d
        )
        files.append(FileResult(rf, compiled, statuses, unsure, rim,
                                spec.file_group_names[0], f_host, f_groups))
    seconds["device"] = time.perf_counter() - t0
    return Evaluation(groups, d, interner, files, dev, seconds)


def _statuses_fields(rule_statuses: Dict[str, Status]) -> dict:
    """The rule lists of a statuses-only FileReport, for a document the
    device settled: failing rules without checks, as the JAX package
    builds them."""
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


def _oracle(rule_file, data_file):
    """One oracle rerun on the CPU evaluator: (doc status, full report,
    merged rule statuses). A GuardError propagates."""
    from ..commands.report import rule_statuses_from_root, simplified_report_from_root
    from ..core.evaluator import eval_rules_file
    from ..core.scopes import RootScope

    scope = RootScope(rule_file.rules, data_file.path_value)
    status = eval_rules_file(rule_file.rules, scope, data_file.name)
    root = scope.reset_recorder().extract()
    return (
        status,
        simplified_report_from_root(root, data_file.name),
        rule_statuses_from_root(root),
    )


def report(validate, evaluation: Evaluation, data_files, writer) -> int:
    """Statuses-only report of an evaluation, rerunning on the CPU
    oracle the documents `rim_masks` selects; the exit code (0 / 19, or
    5 when an oracle rerun raised)."""
    from ..commands.reporters import console_chain
    from ..commands.validate import (
        ERROR_STATUS_CODE,
        FAILURE_STATUS_CODE,
        SUCCESS_STATUS_CODE,
    )

    had_fail = False
    errors = 0
    oracle_s = 0.0
    n = len(data_files)
    for fr in evaluation.files:
        name_st, name_un, doc_st, any_fail, any_un, _last = fr.rim
        host_mask = np.zeros(n, bool)
        host_mask[sorted(fr.host_docs)] = True
        need_oracle, _needs_statuses, _materialize = rim_masks(
            any_fail[:, 0], any_un[:, 0], host_mask,
            bool(fr.compiled.host_rules), False, True,
        )
        # one statuses dict and rule lists per unique status row
        rows: Dict[bytes, tuple] = {}
        for di, df in enumerate(data_files):
            key = name_st[di].tobytes()
            row = rows.get(key)
            if row is None:
                rule_statuses = {
                    nm: STATUS[int(name_st[di, g])] for g, nm in enumerate(fr.names)
                }
                row = rows[key] = (rule_statuses, _statuses_fields(rule_statuses))
            rule_statuses, fields = row
            if need_oracle[di]:
                evaluation.oracle_docs += 1
                t0 = time.perf_counter()
                try:
                    status, rep, oracle_statuses = _oracle(fr.rule_file, df)
                except GuardError as e:
                    writer.writeln_err(str(e))
                    errors += 1
                    continue
                finally:
                    oracle_s += time.perf_counter() - t0
                if not host_mask[di]:
                    # parity assertion: kernel statuses must agree with the
                    # oracle (except results the kernel flagged unsure —
                    # those use the oracle's answer by design)
                    unsure_rules = {
                        nm for g, nm in enumerate(fr.names) if name_un[di, g]
                    }
                    for rn, st in rule_statuses.items():
                        ost = oracle_statuses.get(rn)
                        if ost is not None and ost != st and rn not in unsure_rules:
                            raise GuardError(
                                f"TPU/CPU status divergence for rule {rn} on "
                                f"{df.name}: tpu={st.value} cpu={ost.value}"
                            )
                rule_statuses = oracle_statuses
            else:
                status = STATUS[int(doc_st[di, 0])]
                rep = {"name": df.name, "metadata": {}, "status": status.value, **fields}
            had_fail = had_fail or status == Status.FAIL
            console_chain(
                writer, df.name, df.content, df.path_value, fr.rule_file.name,
                status, rule_statuses, rep, validate.show_summary,
            )
    evaluation.seconds["oracle"] = oracle_s
    if errors:
        return ERROR_STATUS_CODE
    return FAILURE_STATUS_CODE if had_fail else SUCCESS_STATUS_CODE


def validate_statuses(validate, rule_files, data_files, writer) -> int:
    """Drop-in body of Validate.execute for the device: evaluate, then
    report."""
    from ..commands.validate import SUCCESS_STATUS_CODE

    if not data_files or not rule_files:
        return SUCCESS_STATUS_CODE
    t0 = time.perf_counter()
    docs = [df.path_value for df in data_files]
    load_s = time.perf_counter() - t0
    evaluation = evaluate(rule_files, docs, validate.device)
    evaluation.seconds["load"] = load_s
    validate.last_evaluation = evaluation
    t0 = time.perf_counter()
    rc = report(validate, evaluation, data_files, writer)
    evaluation.seconds["report"] = time.perf_counter() - t0 - evaluation.seconds["oracle"]
    return rc
