"""Plain PyTorch versions of the CUDA kernels (csrc/guard_kernels.cu K1-K3
and K7, csrc/guard_joins.cu K4-K6, csrc/guard_walk.cu the tape kernel).

Each computes exactly what its kernel computes, with library calls
(`torch.gather`, `scatter_add_`, `amax`, `sort`, `searchsorted`,
`scatter_reduce_`, `sum`); the tape kernel's runs its program
instruction by instruction. The wrappers in `guard_tpu_torch.kernels`
run these for tensors that lie on the CPU; `chip_smoke.py` and the
card-marked tests hold each kernel against its plain version (the tape
kernel against the eager walk) on the card.
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


# ---------------------------------------------------------------------------
# the tape kernel's instruction set (csrc/guard_walk.cu, ops/tape.py)
# ---------------------------------------------------------------------------

#: the walk's elementwise ops as ops/tape.py records them
(OP_COPY, OP_WHERE, OP_AND, OP_OR, OP_XOR, OP_LNOT, OP_BNOT, OP_EQ, OP_NE, OP_LT,
 OP_LE, OP_GT, OP_GE, OP_ADD, OP_SUB, OP_MUL, OP_MAX, OP_MIN, OP_RED_SUM, OP_RED_OR,
 OP_GROUP_SUM) = range(1, 22)

#: int32 words an instruction of the kernel takes: the op with its dtype
#: and immediate flags, the width (0: one value a document, computed by
#: every lane of its row), a register (the result of ALU, LOAD and GROUP,
#: the source of STORE and the reductions), aux, then four words: the
#: operands a, b, c of an ALU instruction (registers, or immediates where
#: flagged), or the memory (mode, x, y, z) of the others
TAPE_WORDS = 8
I_ALU, I_LOAD, I_GROUP, I_STORE, I_RED_SUM, I_RED_OR = range(1, 7)
#: result dtypes (word 0, bits 8-9): every value is held as an int32 and
#: cut to its dtype after each ALU instruction
DT_BOOL, DT_I8, DT_I32 = 0, 1, 2
IMM_A, IMM_B, IMM_C = 1 << 10, 1 << 11, 1 << 12
#: ALU classes (aux bits 0-2) and their parameters: ADD a + b (a - b with
#: NEG_B); BIT the OR of the masked a & b, a | b, a ^ b, ~a (aux bits
#: 4-7); CMP bit 8 + k of aux, k = 2 (a < b) + (a == b); WHERE a ? b : c
ALU_ADD, ALU_BIT, ALU_CMP, ALU_WHERE, ALU_MAX, ALU_MIN, ALU_MUL = range(7)
ALU_NEG_B = 1 << 3
BIT_AND, BIT_OR, BIT_XOR, BIT_NOT_A = (1 << 4, 1 << 5, 1 << 6, 1 << 7)
CMP_GT, CMP_EQ, CMP_LT = (1 << 8, 1 << 9, 1 << 10)
#: memory modes (the low byte of a mode word): a buffer of the launch
#: (slot x), the workspace at byte D * x, a literal id (`lits[x]`), the
#: column index plus x
M_NONE, M_MEM, M_WS, M_LIT, M_IOTA = range(5)
#: element types of memory (the mode word's second byte)
E_U8, E_I8, E_I32 = 0, 1, 2
#: column maps (the mode word's third byte): the lane's column plus z, or
#: column z for every lane (a per-document read or store)
C_LANE, C_FIXED = 0, 1

_E_DTYPE = {E_U8: torch.uint8, E_I8: torch.int8, E_I32: torch.int32}
_E_SIZE = {E_U8: 1, E_I8: 1, E_I32: 4}


def _cut(x: torch.Tensor, dt: int) -> torch.Tensor:
    if dt == DT_BOOL:
        return (x != 0).to(torch.int32)
    if dt == DT_I8:
        return x.to(torch.int8).to(torch.int32)
    return x


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 back to int32 by two's complement, as the kernel's unsigned
    arithmetic gives."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _memory(mode: int, x: int, y: int, bufs, ws, d: int) -> torch.Tensor:
    """The (D, y) rows a memory operand addresses, viewed in the element
    type the mode names."""
    et = (mode >> 8) & 0xFF
    if mode & 0xFF == M_WS:
        raw = ws[d * x: d * x + d * y * _E_SIZE[et]]
    else:
        raw = bufs[x].reshape(-1).view(torch.uint8)
    return raw.view(_E_DTYPE[et]).view(d, y)


def alu(aux: int, a, b, c):
    """One ALU instruction on int32 tensors, before the dtype's cut."""
    cls = aux & 7
    if cls == ALU_ADD:
        return _wrap(a.long() - b.long() if aux & ALU_NEG_B else a.long() + b.long())
    if cls == ALU_BIT:
        out = torch.zeros_like(torch.broadcast_tensors(a, b)[0])
        for bit, v in ((BIT_AND, lambda: a & b), (BIT_OR, lambda: a | b),
                       (BIT_XOR, lambda: a ^ b), (BIT_NOT_A, lambda: ~a)):
            if aux & bit:
                out = out | v()
        return out
    if cls == ALU_CMP:
        k = (a < b).to(torch.int32) * 2 + (a == b).to(torch.int32)
        return (aux >> (8 + k)) & 1
    if cls == ALU_WHERE:
        return torch.where(a != 0, b, c)
    if cls == ALU_MAX:
        return torch.maximum(a, b)
    if cls == ALU_MIN:
        return torch.minimum(a, b)
    return _wrap(a.long() * b.long())


def walk_segment(prog, n_instr: int, bufs, ws, lits, d: int, w: int) -> None:
    """One launch of the tape kernel over (d, w) lanes, instruction by
    instruction. Each runs over its width's lanes (0: one value a
    document): ALU reads registers and immediates, computes and cuts to
    its dtype; LOAD reads memory, a literal id or the column index, and
    GROUP sums aux columns of memory at a time, into a register; STORE
    writes a register to memory (column z alone for C_FIXED), RED_SUM and
    RED_OR add it, or flag it where non-zero, into a per-document
    accumulator that is zero before the walk. `prog` is the launch's
    int32 program, `bufs` its buffers, `ws` the walk's uint8 workspace,
    `lits` the literal ids."""
    words = prog.tolist()
    regs = {}
    lit_list = lits.tolist()
    dev = ws.device

    def reg(x: int, width: int):
        r = regs[x]
        return r if r.shape[1] == 1 else r[:, :max(width, 1)]

    for pc in range(n_instr):
        op, width, rg, aux, x, y, z, q = words[pc * TAPE_WORDS:(pc + 1) * TAPE_WORDS]
        kind, dt = op & 0xFF, (op >> 8) & 3
        cols = max(width, 1)
        if kind == I_ALU:
            a = torch.tensor(x, dtype=torch.int32, device=dev) if op & IMM_A else reg(x, width)
            b = torch.tensor(y, dtype=torch.int32, device=dev) if op & IMM_B else reg(y, width)
            c = torch.tensor(z, dtype=torch.int32, device=dev) if op & IMM_C else reg(z, width)
            r = _cut(alu(aux, a, b, c), dt)
            regs[rg] = torch.broadcast_to(r, (d, cols)).clone()
            continue
        mode, mx, my, mz = x, y, z, q
        m = mode & 0xFF
        if kind in (I_LOAD, I_GROUP):
            if m == M_LIT:
                r = torch.full((d, 1), lit_list[mx], dtype=torch.int32, device=dev)
            elif m == M_IOTA:
                r = torch.arange(mx, mx + cols, dtype=torch.int32, device=dev)
                r = r[None, :].expand(d, cols)
            else:
                mem = _memory(mode, mx, my, bufs, ws, d)
                if kind == I_GROUP:
                    r = mem[:, :cols * aux].to(torch.int32).view(d, cols, aux).sum(2, dtype=torch.int32)
                elif (mode >> 16) & 0xFF == C_FIXED:
                    r = mem[:, mz:mz + 1].to(torch.int32)
                else:
                    r = mem[:, mz:mz + cols].to(torch.int32)
            regs[rg] = torch.broadcast_to(r, (d, cols if r.shape[1] > 1 or width else 1)).clone()
            continue
        r = reg(rg, width)
        mem = _memory(mode, mx, my, bufs, ws, d)
        if kind == I_RED_SUM:
            acc = mem[:, mz:mz + 1].to(torch.int64) + r.to(torch.int64).sum(1, keepdim=True)
            mem[:, mz:mz + 1] = _wrap(acc).to(mem.dtype)
        elif kind == I_RED_OR:
            mem[:, mz:mz + 1] |= (r != 0).any(1, keepdim=True).to(mem.dtype)
        elif (mode >> 16) & 0xFF == C_FIXED:
            mem[:, mz:mz + 1] = r[:, :1].to(mem.dtype)
        else:
            mem[:, mz:mz + r.shape[1]] = r.to(mem.dtype)
