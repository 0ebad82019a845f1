"""The yardstick of the port's hand-written kernels K1-K7.

`*_bytes` are frozen copies of chip_smoke.py's formulas: the bytes a
launch must move, each input read once and each output written once,
from the launch's shape. `BYTES` computes them from a wrapper's
arguments; `SYMBOLS` names the CUDA kernels (csrc/guard_kernels.cu,
csrc/guard_joins.cu) each wrapper launches, by which a profiler trace
finds their device time. `PEAKS` holds the published peaks of the
cards a run may meet.
"""

from __future__ import annotations

import re


def k1_bytes(d, n, s=None):
    # vec (D, S) read once, idx read and out written (D, N)
    return 4 * d * (n if s is None else s) + 8 * d * n


def k2_bytes(d, n, s):
    return 8 * d * n + 4 * d * s


def k3_bytes(d, r, g, f, with_unsure=True):
    return d * r * (2 if with_unsure else 1) + 8 * r + 4 * g + d * (3 * g + 3 * f)


def k4_bytes(d, nq, ns):
    # queries and set: org, key int32 and a bool mask; counts written
    return 13 * d * nq + 9 * d * ns


def k5_bytes(d, n):
    return 10 * d * n


def k6_bytes(d, n, s):
    # seg, hi, lo int32 and a bool mask read; four int32 per segment written
    return 13 * d * n + 16 * d * s


def k7_bytes(n_valid, r):
    # the valid rows' int8 statuses read, three int32 counts per rule written
    return n_valid * r + 12 * r


def _k1(vec, idx):
    d, n = idx.shape
    return k1_bytes(d, n, vec.shape[1])


def _k2(val, seg, s):
    d, n = val.shape
    return k2_bytes(d, n, s)


def _k3(statuses, unsure, group_ids, file_ids, last_ids, n_groups, n_files):
    d, r = statuses.shape
    return k3_bytes(d, r, n_groups, n_files, unsure is not None)


def _k4(q_org, q_key, q_mask, s_org, s_key, s_mask):
    d, nq = q_org.shape
    return k4_bytes(d, nq, s_org.shape[1])


def _k5(org, key, mask):
    d, n = org.shape
    return k5_bytes(d, n)


def _k6(seg, mask, hi, lo, s):
    d, n = seg.shape
    return k6_bytes(d, n, s)


def _k7(statuses, n_valid):
    return k7_bytes(n_valid, statuses.shape[1])


#: wrapper name in guard_tpu_torch.kernels -> bytes of one launch from
#: the wrapper's arguments
BYTES = {
    "gather_rows": _k1,
    "segment_sum_rows": _k2,
    "rim_reduce": _k3,
    "set_count_rows": _k4,
    "distinct_first_rows": _k5,
    "seg_min_max_rows": _k6,
    "rule_summary": _k7,
}

#: wrapper name -> the CUDA kernels it launches (a trace's kernel names
#: carry template arguments and parameter lists around these)
SYMBOLS = {
    "gather_rows": ("gather_rows_kernel",),
    "segment_sum_rows": ("segment_sum_rows_kernel", "segment_sum_split_kernel"),
    "rim_reduce": ("rim_reduce_kernel", "rim_rows_kernel", "rim_warp_kernel"),
    "set_count_rows": ("set_count_rows_kernel", "set_count_insert_kernel",
                       "set_count_probe_kernel"),
    "distinct_first_rows": ("distinct_first_rows_kernel", "distinct_first_insert_kernel",
                            "distinct_first_probe_kernel"),
    "seg_min_max_rows": ("seg_min_max_kernel", "seg_min_max_fold_kernel",
                         "seg_min_max_unpack_kernel"),
    "rule_summary": ("rule_summary_kernel", "rule_summary_cluster_kernel"),
}


_SYMBOL_RE = re.compile(
    r"(?<![A-Za-z0-9_])("
    + "|".join(sym for syms in SYMBOLS.values() for sym in syms)
    + r")(?![A-Za-z0-9_])"
)
_WRAPPER = {sym: wrapper for wrapper, syms in SYMBOLS.items() for sym in syms}


def wrapper_of(kernel_name: str):
    """The wrapper whose kernels include this trace name, or None."""
    m = _SYMBOL_RE.search(kernel_name)
    return _WRAPPER[m.group(1)] if m else None


#: published peaks by the card's name (NVIDIA's data sheet, SXM part,
#: dense rates): HBM bytes a second
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_name: str):
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks["hbm_bytes_per_s"]
    return None
