"""The statuses-only `validate` path on the device.

Shaped like the JAX package's `tpu_validate` (guard_tpu/ops/backend.py:
1695) under `--statuses-only`: encode the documents, lower every rule
file, evaluate each file bucket by bucket on the device with the rim
reductions behind it, mask the rim blocks (`rim_masks`), and report
each (rules file, document) pair from its merged rule statuses.

Inputs the JAX package would send to its host oracle are refused with
`HostOracleNeeded` (exit code 5 at the CLI), never routed to the CPU:
host rules, function variables, documents over the last node bucket or
with numbers that have no exact device encoding, and any unsure bit
(a list IN a subset-mode list, a non-string `.%var` key, `.%var[k]`
over unresolved entries, elementwise `empty` on a number). Constructs
whose device kernels come with a later slice (function-variable roots,
StepFnVar) are refused with `NotInSlice`, also exit code 5.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..core.errors import GuardError
from ..core.qresult import Status
from ..core.values import MAP
from .encoder import Interner, encode_bucketed
from .ir import FAIL, PASS, SKIP, CompiledRules, build_rim_spec, compile_rules_file
from ..parallel.device import DeviceBatchEvaluator, evaluate_groups, resolve_device

STATUS = {PASS: Status.PASS, FAIL: Status.FAIL, SKIP: Status.SKIP}


class HostOracleNeeded(GuardError):
    """The input needs the JAX package's host oracle, which a later slice
    of the port brings; the port refuses it instead of evaluating on the
    CPU."""

    def __init__(self, detail: str):
        super().__init__(
            f"{detail}: this input needs the host oracle, which a later "
            "slice of the torch port brings"
        )


class NotInSlice(GuardError):
    """The rules use a construct whose device kernels come with a later
    slice of the port."""


@dataclass
class FileResult:
    """One rules file's device evaluation over the whole batch."""

    rule_file: object  # commands.validate.RuleFile
    compiled: CompiledRules
    statuses: np.ndarray  # (D, R) int8
    unsure: np.ndarray  # (D, R) bool
    rim: tuple  # six (D, ...) blocks, kernels.rim_reduce order
    names: List[str]  # name groups, declaration order


@dataclass
class Evaluation:
    groups: list  # [(bucket DocBatch, doc indices)], encode_bucketed
    n_docs: int
    interner: Interner
    files: List[FileResult]
    device: torch.device
    # host clock seconds per phase: load (parse the documents; set by
    # validate_statuses), encode, lower, device (ends when the last
    # bucket is collected), report
    seconds: Dict[str, float] = field(default_factory=dict)


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


def evaluate(rule_files, docs, device=None) -> Evaluation:
    """Encode `docs` (PV trees), lower every rules file and evaluate it
    on `device` (CUDA unless given). Raises HostOracleNeeded for an input
    this slice cannot decide on the device."""
    dev = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    groups, oversize, interner = encode_bucketed(docs)
    seconds["encode"] = time.perf_counter() - t0
    if len(oversize):
        raise HostOracleNeeded(
            f"{len(oversize)} document(s) exceed the largest node bucket or "
            "hold numbers with no exact device encoding"
        )

    t0 = time.perf_counter()
    lowered = []
    for rf in rule_files:
        compiled = compile_rules_file(rf.rules, interner)
        if compiled.fn_vars:
            raise HostOracleNeeded(
                f"{rf.name}: function variables need per-document precompute"
            )
        if compiled.host_rules:
            names = ", ".join(r.rule_name for r in compiled.host_rules)
            raise HostOracleNeeded(
                f"{rf.name}: rules [{names}] do not lower to the device"
            )
        spec = build_rim_spec([compiled.rules])
        try:
            ev = DeviceBatchEvaluator(compiled, dev, rim_spec=spec)
        except NotImplementedError as e:
            raise NotInSlice(f"{rf.name}: {e}") from None
        lowered.append((rf, compiled, ev, spec.file_group_names[0]))
    seconds["lower"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    d = len(docs)
    files = []
    for rf, compiled, ev, names in lowered:
        statuses, unsure, _host, rim = evaluate_groups(
            ev, len(compiled.rules), groups, (), d
        )
        files.append(FileResult(rf, compiled, statuses, unsure, rim, names))
    seconds["device"] = time.perf_counter() - t0
    return Evaluation(groups, d, interner, files, dev, seconds)


def _root_keys(pv) -> set:
    return set(pv.val.values) if pv.kind == MAP else set()


def report(validate, evaluation: Evaluation, data_files, writer) -> int:
    """Statuses-only report of an evaluation; the exit code (0 / 19).
    Raises HostOracleNeeded when a document carries an unsure bit."""
    from ..commands.reporters import console_chain
    from ..commands.validate import FAILURE_STATUS_CODE, SUCCESS_STATUS_CODE

    for fr in evaluation.files:
        _name_st, _name_un, _doc_st, any_fail, any_un, _last = fr.rim
        need_oracle, _needs_statuses, _materialize = rim_masks(
            any_fail[:, 0], any_un[:, 0], np.zeros(len(data_files), bool),
            False, False, True,
        )
        if need_oracle.any():
            raise HostOracleNeeded(
                f"{fr.rule_file.name}: {int(need_oracle.sum())} document(s) "
                "have results the device cannot decide exactly"
            )
    had_fail = False
    for fr in evaluation.files:
        name_st = fr.rim[0]
        doc_st = fr.rim[2][:, 0]
        rows: Dict[bytes, Dict[str, Status]] = {}  # one dict per unique row
        for di, df in enumerate(data_files):
            key = name_st[di].tobytes()
            rule_statuses = rows.get(key)
            if rule_statuses is None:
                rule_statuses = rows[key] = {
                    n: STATUS[int(name_st[di, g])] for g, n in enumerate(fr.names)
                }
            status = STATUS[int(doc_st[di])]
            had_fail = had_fail or status == Status.FAIL
            console_chain(
                writer, df.name, fr.rule_file.name, status, rule_statuses,
                _root_keys(df.path_value), validate.show_summary,
            )
    return FAILURE_STATUS_CODE if had_fail else SUCCESS_STATUS_CODE


def validate_statuses(validate, rule_files, data_files, writer) -> int:
    """Drop-in body of Validate.execute for the device: evaluate, then
    report. HostOracleNeeded propagates to the caller."""
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
    evaluation.seconds["report"] = time.perf_counter() - t0
    return rc
