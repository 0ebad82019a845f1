"""Plain PyTorch versions of the CUDA kernels (csrc/guard_kernels.cu K1-K3
and K7, csrc/guard_joins.cu K4-K6).

Each computes exactly what its kernel computes, with library calls
(`torch.gather`, `scatter_add_`, `amax`, `sort`, `searchsorted`,
`scatter_reduce_`, `sum`). The wrappers in `guard_tpu_torch.kernels` run these
for tensors that lie on the CPU; `chip_smoke.py` and the card-marked
tests hold each kernel against its plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Status.and_ as a priority order (FAIL > PASS > SKIP): status code ->
# priority, and back (guard_tpu/ops/kernels.py:1962-1963)
_STATUS_PRIO = (1, 2, 0)  # PASS, FAIL, SKIP
_PRIO_STATUS = (2, 0, 1)  # -> SKIP, PASS, FAIL

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def gather_rows(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[d, i] = vec[d, idx[d, i]] where 0 <= idx < S, else 0; vec is
    (D, S), idx and out (D, N)."""
    s = vec.shape[1]
    ok = (idx >= 0) & (idx < s)
    if s == 0:
        return torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    got = torch.gather(vec, 1, torch.where(ok, idx, 0).long())
    return torch.where(ok, got, 0).to(torch.int32)


def segment_sum_rows(val: torch.Tensor, seg: torch.Tensor, s: int) -> torch.Tensor:
    """out[d, b] = sum of val[d, i] over i with seg[d, i] == b, for
    b in [0, s); lanes with seg outside that range add nothing."""
    ok = (seg >= 0) & (seg < s)
    out = torch.zeros((val.shape[0], s), dtype=torch.int32, device=val.device)
    out.scatter_add_(
        1, torch.where(ok, seg, 0).long(), torch.where(ok, val, 0).to(torch.int32)
    )
    return out


def pair_keys(org: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The 64-bit join key of an (org, key) pair: org in the high word,
    the key's 32 bits in the low word. Non-negative for org >= 0."""
    return (org.long() << 32) | (key.long() & 0xFFFFFFFF)


def set_count_rows(q_org, q_key, q_mask, s_org, s_key, s_mask) -> torch.Tensor:
    """(D, Nq) int32: for each query entry with q_mask set and q_org >= 0,
    the number of set entries with s_mask set, s_org >= 0 and the same
    (org, key); every other query entry reads 0. Queries are (D, Nq),
    the set (D, Ns) with any Ns."""
    valid_s = s_mask & (s_org >= 0)
    valid_q = q_mask & (q_org >= 0)
    # excluded set entries sort first as -1 and match no valid query key
    s = torch.where(valid_s, pair_keys(s_org, s_key), -1)
    s_sorted = torch.sort(s, dim=1).values
    q = pair_keys(q_org, q_key)
    lo = torch.searchsorted(s_sorted, q, right=False)
    hi = torch.searchsorted(s_sorted, q, right=True)
    return torch.where(valid_q, hi - lo, 0).to(torch.int32)


def distinct_first_rows(org, key, mask) -> torch.Tensor:
    """(D, N) bool: True exactly at the lowest index of each distinct
    (org, key) among entries with mask set and org >= 0."""
    valid = mask & (org >= 0)
    p = torch.where(valid, pair_keys(org, key), -1)
    order = torch.sort(p, dim=1, stable=True)
    ps = order.values
    start = torch.ones_like(ps, dtype=torch.bool)
    start[:, 1:] = ps[:, 1:] != ps[:, :-1]
    first = start & (ps >= 0)
    return torch.zeros_like(valid).scatter_(1, order.indices, first)


def pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 -> int64 whose signed order is the signed
    lexicographic (hi, lo) order."""
    return (hi.long() << 32) | ((lo.long() & 0xFFFFFFFF) ^ 0x80000000)


def unpack_key(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = (p >> 32).to(torch.int32)
    low = (p & 0xFFFFFFFF) ^ 0x80000000
    lo = torch.where(low >= (1 << 31), low - (1 << 32), low).to(torch.int32)
    return hi, lo


def seg_min_max_rows(seg, mask, hi, lo, s: int):
    """(min_hi, min_lo, max_hi, max_lo), (D, s) int32 each: the signed
    lexicographic (hi, lo) minimum and maximum over the entries with
    mask set and seg in [0, s). An empty segment reads (INT32_MAX,
    INT32_MAX) as its minimum and (INT32_MIN, INT32_MIN) as its maximum."""
    d = seg.shape[0]
    ok = mask & (seg >= 0) & (seg < s)
    idx = torch.where(ok, seg, 0).long()
    p = pack_key(hi, lo)
    mn = torch.full((d, s), _I64_MAX, dtype=torch.int64, device=seg.device)
    mx = torch.full((d, s), _I64_MIN, dtype=torch.int64, device=seg.device)
    mn.scatter_reduce_(1, idx, torch.where(ok, p, _I64_MAX), "amin")
    mx.scatter_reduce_(1, idx, torch.where(ok, p, _I64_MIN), "amax")
    return (*unpack_key(mn), *unpack_key(mx))


def rim_reduce(statuses: torch.Tensor, unsure: Optional[torch.Tensor],
               group_ids: torch.Tensor, file_ids: torch.Tensor,
               last_ids: torch.Tensor, n_groups: int, n_files: int):
    """(name_status (D,G) i8, name_unsure (D,G) bool, doc_status (D,F)
    i8, any_fail (D,F) bool, any_unsure (D,F) bool, name_last (D,G) i8):
    segment max over the status priority, empty segments SKIP; segment
    OR, empty segments False."""
    dev = statuses.device
    d = statuses.shape[0]
    to_prio = torch.tensor(_STATUS_PRIO, dtype=torch.int8, device=dev)
    to_status = torch.tensor(_PRIO_STATUS, dtype=torch.int8, device=dev)
    prio = to_prio[statuses.long()]
    gid = group_ids.cpu().tolist()
    fid = file_ids.cpu().tolist()

    def seg_max(vals: torch.Tensor, ids, n: int) -> torch.Tensor:
        out = torch.zeros((d, n), dtype=torch.int8, device=dev)
        for k in range(n):
            cols = [i for i, s in enumerate(ids) if s == k]
            if cols:
                sel = torch.tensor(cols, dtype=torch.long, device=dev)
                out[:, k] = vals.index_select(1, sel).amax(dim=1)
        return out

    name_status = to_status[seg_max(prio, gid, n_groups).long()]
    doc_status = to_status[seg_max(prio, fid, n_files).long()]
    any_fail = seg_max((statuses == 1).to(torch.int8), fid, n_files) > 0
    if unsure is None:
        name_unsure = torch.zeros((d, n_groups), dtype=torch.bool, device=dev)
        any_unsure = torch.zeros((d, n_files), dtype=torch.bool, device=dev)
    else:
        u = unsure.to(torch.int8)
        name_unsure = seg_max(u, gid, n_groups) > 0
        any_unsure = seg_max(u, fid, n_files) > 0
    name_last = statuses.index_select(1, last_ids.long())
    return name_status, name_unsure, doc_status, any_fail, any_unsure, name_last


def rule_summary(statuses: torch.Tensor, n_valid: int) -> torch.Tensor:
    """(3, R) int32: per rule, the rows d < n_valid of the (D, R) int8
    statuses that read PASS (0), FAIL (1) and SKIP (2); any other value
    counts nowhere."""
    d = statuses.shape[0]
    valid = torch.arange(d, device=statuses.device) < n_valid
    return torch.stack(
        [((statuses == k) & valid[:, None]).sum(0) for k in (0, 1, 2)]
    ).to(torch.int32)
