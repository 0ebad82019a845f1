"""Wrappers of the hand-written CUDA kernels: K1-K3 and K7 in
csrc/guard_kernels.cu, K4-K6 in csrc/guard_joins.cu, and the tape
kernel `walk_segment` (csrc/guard_walk.cu) that runs one level of the
walk's elementwise ops (ops/tape.py).

Each wrapper takes batched row-major tensors. For a CUDA tensor it
checks dtype, shape and contiguity, makes the tensors' card the
thread's current device for the call (the launchers read the current
device for their per-card occupancy, shared-memory and cluster
settings), launches its kernel on PyTorch's current stream of that card
and adds one to its entry in `LAUNCHES` (one a call,
also where the launcher issues a memset and several grids, as K2 and K4-K6
do for one-document buckets); a refused launch raises. For a CPU tensor it returns the plain PyTorch version
(`kernels/plain.py`) and counts nothing. There is no other path.

`SHAPES` records the argument shape of every launch, so a measurement
can time each kernel at the shapes the evaluation actually gave it.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional

import torch

from . import plain

NAMES = (
    "gather_rows", "segment_sum_rows", "rim_reduce",
    "set_count_rows", "distinct_first_rows", "seg_min_max_rows",
    "rule_summary", "walk_segment",
)
LAUNCHES = {name: 0 for name in NAMES}
SHAPES = {name: Counter() for name in NAMES}


def reset_launches() -> None:
    for name in NAMES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


def _lib():
    from .build import load

    return load()


def _on_cuda(*tensors) -> bool:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _on_its_card(wrapper):
    """Run a wrapper whose first argument lies on a CUDA card with that
    card as the thread's current device, whatever the caller's current
    device is: a launch then pairs the card with its own stream."""

    @functools.wraps(wrapper)
    def call(first, *args, **kwargs):
        dev = first.device
        if dev.type == "cuda" and dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return wrapper(first, *args, **kwargs)
        return wrapper(first, *args, **kwargs)

    return call


def _check(t: torch.Tensor, dtype, ndim: int, what: str) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-D {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")


@_on_its_card
def gather_rows(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1: out[d, i] = vec[d, idx[d, i]] where 0 <= idx < S, else 0.
    vec (D, S), idx and out (D, N), int32 each."""
    if not _on_cuda(vec, idx):
        return plain.gather_rows(vec, idx)
    _check(vec, torch.int32, 2, "gather_rows vec")
    _check(idx, torch.int32, 2, "gather_rows idx")
    if vec.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_rows: {tuple(vec.shape)} vs {tuple(idx.shape)}")
    out = torch.empty_like(idx)
    d, n = idx.shape
    s = vec.shape[1]
    if out.numel() == 0:
        return out
    _raise_on(
        _lib().guard_gather_rows(
            vec.data_ptr(), idx.data_ptr(), out.data_ptr(), d, n, s, _stream(vec)
        ),
        "gather_rows",
    )
    LAUNCHES["gather_rows"] += 1
    SHAPES["gather_rows"][(d, n, s)] += 1
    return out


@_on_its_card
def segment_sum_rows(val: torch.Tensor, seg: torch.Tensor, s: int) -> torch.Tensor:
    """K2: out[d, b] = sum of val[d, i] over i with seg[d, i] == b, for
    b in [0, s). (D, N) int32 in, (D, s) int32 out."""
    if not _on_cuda(val, seg):
        return plain.segment_sum_rows(val, seg, s)
    _check(val, torch.int32, 2, "segment_sum_rows val")
    _check(seg, torch.int32, 2, "segment_sum_rows seg")
    if val.shape != seg.shape:
        raise ValueError(
            f"segment_sum_rows: {tuple(val.shape)} vs {tuple(seg.shape)}"
        )
    d, n = val.shape
    out = torch.empty((d, s), dtype=torch.int32, device=val.device)
    if out.numel() == 0:
        return out
    _raise_on(
        _lib().guard_segment_sum_rows(
            val.data_ptr(), seg.data_ptr(), out.data_ptr(), d, n, s,
            _stream(val),
        ),
        "segment_sum_rows",
    )
    LAUNCHES["segment_sum_rows"] += 1
    SHAPES["segment_sum_rows"][(d, n, s)] += 1
    return out


@_on_its_card
def rim_reduce(statuses: torch.Tensor, unsure: Optional[torch.Tensor],
               group_ids: torch.Tensor, file_ids: torch.Tensor,
               last_ids: torch.Tensor, n_groups: int, n_files: int):
    """K3: the six rim blocks of (D, R) int8 statuses and (D, R) bool
    unsure bits (or None): (name_status (D,G) i8, name_unsure (D,G)
    bool, doc_status (D,F) i8, any_fail (D,F) bool, any_unsure (D,F)
    bool, name_last (D,G) i8). group/file ids are (R,) int32 and
    last_ids (G,) int32, on the same device."""
    extra = () if unsure is None else (unsure,)
    if not _on_cuda(statuses, group_ids, file_ids, last_ids, *extra):
        return plain.rim_reduce(
            statuses, unsure, group_ids, file_ids, last_ids, n_groups, n_files
        )
    _check(statuses, torch.int8, 2, "rim_reduce statuses")
    if unsure is not None:
        _check(unsure, torch.bool, 2, "rim_reduce unsure")
        if unsure.shape != statuses.shape:
            raise ValueError("rim_reduce: unsure and statuses differ in shape")
    d, r = statuses.shape
    for t, size, what in ((group_ids, r, "group_ids"), (file_ids, r, "file_ids"),
                          (last_ids, n_groups, "last_ids")):
        _check(t, torch.int32, 1, f"rim_reduce {what}")
        if t.shape[0] != size:
            raise ValueError(f"rim_reduce {what}: length {t.shape[0]}, want {size}")
    lib = _lib()
    if 2 * n_groups + 3 * n_files > lib.rim_max_slots:
        raise ValueError(
            f"rim_reduce: {n_groups} groups and {n_files} files exceed one "
            "block's shared memory"
        )
    out = _rim_blocks(d, n_groups, n_files, statuses.device)
    if d == 0:
        return out
    _raise_on(
        lib.guard_rim_reduce(
            statuses.data_ptr(), None if unsure is None else unsure.data_ptr(),
            group_ids.data_ptr(), file_ids.data_ptr(), last_ids.data_ptr(),
            *(t.data_ptr() for t in out), d, r, n_groups, n_files,
            _stream(statuses),
        ),
        "rim_reduce",
    )
    LAUNCHES["rim_reduce"] += 1
    SHAPES["rim_reduce"][(d, r, n_groups, n_files)] += 1
    return out


def _rim_blocks(d: int, g: int, f: int, device):
    """K3's six outputs as views of one int8 buffer (one allocation a
    call), each block on 128-byte lines of its own, so the writes of two
    blocks never share a line; the flags are bool views."""
    widths = (g, g, f, f, f, g)
    sizes = [-(-d * w // 128) * 128 for w in widths]
    buf = torch.empty(sum(sizes), dtype=torch.int8, device=device)
    out, offset = [], 0
    for i, (w, size) in enumerate(zip(widths, sizes)):
        block = buf.as_strided((d, w), (w, 1), offset)
        out.append(block.view(torch.bool) if i in (1, 3, 4) else block)
        offset += size
    return tuple(out)


@_on_its_card
def set_count_rows(q_org: torch.Tensor, q_key: torch.Tensor, q_mask: torch.Tensor,
                   s_org: torch.Tensor, s_key: torch.Tensor,
                   s_mask: torch.Tensor) -> torch.Tensor:
    """K4: (D, Nq) int32, for each query entry with q_mask and q_org >= 0
    the number of set entries with s_mask, s_org >= 0 and the same
    (org, key); 0 elsewhere. Queries (D, Nq), set (D, Ns): org and key
    int32, masks bool."""
    if not _on_cuda(q_org, q_key, q_mask, s_org, s_key, s_mask):
        return plain.set_count_rows(q_org, q_key, q_mask, s_org, s_key, s_mask)
    for t, dt, what in ((q_org, torch.int32, "q_org"), (q_key, torch.int32, "q_key"),
                        (q_mask, torch.bool, "q_mask"), (s_org, torch.int32, "s_org"),
                        (s_key, torch.int32, "s_key"), (s_mask, torch.bool, "s_mask")):
        _check(t, dt, 2, f"set_count_rows {what}")
    if not (q_org.shape == q_key.shape == q_mask.shape
            and s_org.shape == s_key.shape == s_mask.shape
            and q_org.shape[0] == s_org.shape[0]):
        raise ValueError(
            f"set_count_rows: queries {tuple(q_org.shape)}, set {tuple(s_org.shape)}"
        )
    d, nq = q_org.shape
    ns = s_org.shape[1]
    out = torch.empty_like(q_org)
    if out.numel() == 0:
        return out
    lib = _lib()
    # tables in global scratch where the launcher takes its global branch
    scratch = None
    if lib.guard_set_count_branch(d, ns) == 0:
        scratch = torch.empty(lib.guard_set_count_scratch(d, ns), dtype=torch.uint8,
                              device=q_org.device)
    _raise_on(
        lib.guard_set_count_rows(
            q_org.data_ptr(), q_key.data_ptr(), q_mask.data_ptr(),
            s_org.data_ptr(), s_key.data_ptr(), s_mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            d, nq, ns, _stream(q_org),
        ),
        "set_count_rows",
    )
    LAUNCHES["set_count_rows"] += 1
    SHAPES["set_count_rows"][(d, nq, ns)] += 1
    return out


@_on_its_card
def distinct_first_rows(org: torch.Tensor, key: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """K5: (D, N) bool, True exactly at the lowest index of each distinct
    (org, key) among entries with mask and org >= 0."""
    if not _on_cuda(org, key, mask):
        return plain.distinct_first_rows(org, key, mask)
    _check(org, torch.int32, 2, "distinct_first_rows org")
    _check(key, torch.int32, 2, "distinct_first_rows key")
    _check(mask, torch.bool, 2, "distinct_first_rows mask")
    if not org.shape == key.shape == mask.shape:
        raise ValueError("distinct_first_rows: org, key and mask differ in shape")
    d, n = org.shape
    out = torch.empty_like(mask)
    if out.numel() == 0:
        return out
    lib = _lib()
    # tables in global scratch where the launcher takes its global form
    scratch = None
    if lib.guard_distinct_first_branch(d, n) == 0:
        scratch = torch.empty(lib.guard_distinct_first_scratch(d, n), dtype=torch.uint8,
                              device=org.device)
    _raise_on(
        lib.guard_distinct_first_rows(
            org.data_ptr(), key.data_ptr(), mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            d, n, _stream(org),
        ),
        "distinct_first_rows",
    )
    LAUNCHES["distinct_first_rows"] += 1
    SHAPES["distinct_first_rows"][(d, n)] += 1
    return out


@_on_its_card
def seg_min_max_rows(seg: torch.Tensor, mask: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor, s: int):
    """K6: (min_hi, min_lo, max_hi, max_lo), (D, s) int32 each: the
    signed lexicographic (hi, lo) min and max over entries with mask and
    seg in [0, s); an empty segment reads (INT32_MAX, INT32_MAX) and
    (INT32_MIN, INT32_MIN). seg, hi, lo (D, N) int32, mask (D, N) bool."""
    if not _on_cuda(seg, mask, hi, lo):
        return plain.seg_min_max_rows(seg, mask, hi, lo, s)
    _check(seg, torch.int32, 2, "seg_min_max_rows seg")
    _check(mask, torch.bool, 2, "seg_min_max_rows mask")
    _check(hi, torch.int32, 2, "seg_min_max_rows hi")
    _check(lo, torch.int32, 2, "seg_min_max_rows lo")
    if not seg.shape == mask.shape == hi.shape == lo.shape:
        raise ValueError("seg_min_max_rows: seg, mask, hi and lo differ in shape")
    d, n = seg.shape
    out = tuple(
        torch.empty((d, s), dtype=torch.int32, device=seg.device) for _ in range(4)
    )
    if d == 0 or s == 0:
        return out
    lib = _lib()
    # tables in global scratch where the launcher takes its grid form
    scratch = None
    if lib.guard_seg_min_max_branch(d, n, s) == 0:
        scratch = torch.empty(lib.guard_seg_min_max_scratch(d, s), dtype=torch.uint8,
                              device=seg.device)
    _raise_on(
        lib.guard_seg_min_max_rows(
            seg.data_ptr(), mask.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            *(t.data_ptr() for t in out),
            scratch.data_ptr() if scratch is not None else None,
            d, n, s, _stream(seg),
        ),
        "seg_min_max_rows",
    )
    LAUNCHES["seg_min_max_rows"] += 1
    SHAPES["seg_min_max_rows"][(d, n, s)] += 1
    return out


@_on_its_card
def rule_summary(statuses: torch.Tensor, n_valid: int) -> torch.Tensor:
    """K7: (3, R) int32 per-rule counts of PASS (0), FAIL (1) and SKIP
    (2) over the rows d < n_valid of (D, R) int8 statuses; any other
    value counts nowhere. n_valid is clamped to [0, D]."""
    if not _on_cuda(statuses):
        return plain.rule_summary(statuses, n_valid)
    _check(statuses, torch.int8, 2, "rule_summary statuses")
    d, r = statuses.shape
    n = min(max(int(n_valid), 0), d)
    if n == 0 or r == 0:
        return torch.zeros((3, r), dtype=torch.int32, device=statuses.device)
    # the launcher writes every counter (one block) or zeroes the output
    # on the stream before its grid adds into it
    out = torch.empty((3, r), dtype=torch.int32, device=statuses.device)
    _raise_on(
        _lib().guard_rule_summary(
            statuses.data_ptr(), out.data_ptr(), d, r, n, _stream(statuses)
        ),
        "rule_summary",
    )
    LAUNCHES["rule_summary"] += 1
    SHAPES["rule_summary"][(d, r, n)] += 1
    return out


@_on_its_card
def walk_segment(prog: torch.Tensor, start: int, n_instr: int, bufs, ws: torch.Tensor,
                 lits: torch.Tensor, d: int, w: int, n_regs: int, zero_bytes: int = 0) -> None:
    """The tape kernel: instructions [start, start + n_instr) of the
    int32 program `prog` (plain.TAPE_WORDS words each) over (d, w)
    lanes, reading and writing the tensors `bufs` (by slot), the uint8
    workspace `ws` and the (L,) int32 literal ids `lits`; `n_regs`
    registers a lane. The first `zero_bytes` of `ws` are zeroed before
    the launch. Writes in place; returns nothing."""
    if not _on_cuda(prog, ws, lits, *bufs):
        if zero_bytes:
            ws[:zero_bytes].zero_()
        words = plain.TAPE_WORDS
        plain.walk_segment(prog[start * words:(start + n_instr) * words], n_instr,
                           bufs, ws, lits, d, w)
        return
    _check(prog, torch.int32, 1, "walk_segment prog")
    _check(lits, torch.int32, 1, "walk_segment lits")
    _check(ws, torch.uint8, 1, "walk_segment ws")
    for t in bufs:
        if not t.is_contiguous():
            raise ValueError("walk_segment: a buffer is not contiguous")
    lib = _lib()
    if len(bufs) > lib.walk_max_bufs:
        raise ValueError(f"walk_segment: {len(bufs)} buffers, at most {lib.walk_max_bufs}")
    if d == 0 or n_instr == 0:
        return
    ptrs = (ctypes.c_longlong * max(len(bufs), 1))(*(t.data_ptr() for t in bufs))
    word = prog.data_ptr() + 4 * plain.TAPE_WORDS * start
    _raise_on(
        lib.guard_walk_segment(
            word, n_instr, ctypes.cast(ptrs, ctypes.c_void_p), len(bufs), ws.data_ptr(), lits.data_ptr(), d, w,
            n_regs, zero_bytes, _stream(ws),
        ),
        "walk_segment",
    )
    LAUNCHES["walk_segment"] += 1
    SHAPES["walk_segment"][(d, w, n_instr)] += 1
