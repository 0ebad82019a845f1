"""The walk as a tape: one launch of the tape kernel per dataflow level.

The eager walk (ops/kernels.py) issues some two thousand small torch
ops a bucket, each a kernel on the card. Its control flow depends on
the program alone (no value is read back, no shape depends on data), so
one program at one node bucket always issues the same ops. This module
records them once per program and replays them:

  * **record**: the eager walk runs on the CPU over zero columns of
    `D_REC` rows and `WIDTHS[0]` nodes, under a dispatch mode that
    notes every aten op, and with the kernels K1, K2 and K4-K6 stood in
    by stubs that note each call (`ops/kernels.py` routes its kernel
    calls through the recorder of the thread). No card is touched, and
    nothing the walk computes there is read. The tape is generic in D,
    since every size it holds is a width, and in the node width N: the
    record, copied to a second width, compiles to a second tape, and
    every number of the two is a * N + b (`Program`), so one recording
    gives every bucket's tape.
  * **schedule**: casts that change no value and repeated ops go; each
    elementwise op goes to the earliest level its inputs allow (the
    kernels, the row reductions and reads across lanes wait for the
    level before), then sinks to the latest level its readers allow;
    ops nothing reads are dropped.
  * **replay**: per level one launch of `kernels.walk_segment`, which
    interprets the level's instructions over (D, N) lanes, keeping
    values in registers and writing only what a later level or a kernel
    reads, into a workspace whose slots are reused by liveness; the
    kernel calls in between go through `guard_tpu_torch.kernels`' module
    attributes with the arguments the eager walk gave them. A batch
    whose workspace would pass MAX_WORKSPACE replays in slices of rows.

A program whose walk uses an op the recorder does not cover (the
recorder raises `Unsupported`) takes the eager walk; any other error of
a recording propagates. `build_fused_evaluator` counts which path each
walk took (`walks_fused`, `walks_eager` of the telemetry group
`dispatch`).
"""

from __future__ import annotations

import gc
import heapq
import threading
import weakref
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from .. import kernels as K
from ..kernels import plain as isa
from . import kernels as walk

#: the rows of a recording: no width of a walk is 3 (a node bucket is a
#: multiple of 8, and a walk's widths are N, N + 1 and their multiples)
D_REC = 3
#: registers of a launch (the kernel's shared memory holds them for 128
#: lanes); values beyond them go to the workspace
MAX_REGS = 80
#: registers of a launch kept for the loads of one instruction's memory
#: operands and for a result that has no register of its own
TEMPS = 4
#: the largest workspace a replay allocates; a bigger batch of a long
#: program (a pack of hundreds of rules, a row of ~0.25 MB) replays in
#: slices of rows
MAX_WORKSPACE = 4 << 30
#: buffers one launch reads or writes besides the workspace
#: (csrc/guard_walk.cu TAPE_MAX_BUFS)
MAX_BUFS = 1024
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

_TLS = walk._RECORDING


class Unsupported(Exception):
    """The walk used an op the tape does not cover."""


# ---------------------------------------------------------------------------
# values and instructions
# ---------------------------------------------------------------------------

_DT = {torch.bool: isa.DT_BOOL, torch.int8: isa.DT_I8, torch.int32: isa.DT_I32,
       torch.int64: isa.DT_I32}
_ET = {torch.bool: isa.E_U8, torch.uint8: isa.E_U8, torch.int8: isa.E_I8,
       torch.int32: isa.E_I32, torch.int64: isa.E_I32}
_ESIZE = {isa.E_U8: 1, isa.E_I8: 1, isa.E_I32: 4}


class Val:
    """One value of the tape. `width` is W for a (D, W) value, 0 for a
    per-document (D,) or (D, 1) value, None for a scalar. Kinds:
    in (an input column, `src` its key), const, lit (`src` the index),
    iota (the column index plus `src`), ew (an instruction's result),
    bar (a kernel's output), red (a row reduction's), cat, out (a walk
    output), and the views slice (`src` a value, `off` a column offset),
    col (column `off` of `src`, per document), bcast (a per-document
    `src` across W columns), group (`src` read k columns at a time)."""

    __slots__ = ("kind", "dtype", "width", "src", "off", "instr", "bar", "parts",
                 "consumers", "lo", "hi", "ws", "wsize", "first", "last", "stored",
                 "reg")

    def __init__(self, kind, dtype, width, src=None, off=0):
        self.kind, self.dtype, self.width = kind, dtype, width
        self.src, self.off = src, off
        self.instr = self.bar = None
        self.parts = None
        self.consumers = []
        self.lo, self.hi = _I32_MIN, _I32_MAX
        self.ws = None  # workspace byte offset a row, once placed
        self.wsize = 0
        self.first = self.last = None
        self.stored = False
        self.reg = None


class Instr:
    __slots__ = ("op", "dtype", "width", "args", "out", "level", "aux", "target",
                 "tcol", "dead", "pos")

    def __init__(self, op, dtype, width, args, out=None, aux=0, target=None, tcol=0):
        self.op, self.dtype, self.width, self.args = op, dtype, width, args
        self.out, self.aux = out, aux
        # a store-only instruction writes `target` (a red, cat or out
        # value) at column `tcol`
        self.target, self.tcol = target, tcol
        self.level = 0
        self.dead = False
        self.pos = 0


class Barrier:
    __slots__ = ("name", "args", "outs", "level", "fnvar", "pos")

    def __init__(self, name, args, outs, fnvar):
        self.name, self.args, self.outs, self.fnvar = name, args, outs, fnvar
        self.level = -1
        self.pos = 0


def _base(v: Val):
    """(value, access) of a read: access is ("lane", offset), ("fixed",
    column), ("bcast",) or ("group", k) against a value that is not a
    view."""
    if v.kind == "slice":
        b, acc = _base(v.src)
        if acc[0] != "lane":
            raise Unsupported("slice of a non-row view")
        return b, ("lane", acc[1] + v.off)
    if v.kind == "col":
        b, acc = _base(v.src)
        if acc[0] != "lane":
            raise Unsupported("column of a non-row view")
        return b, ("fixed", acc[1] + v.off)
    if v.kind == "bcast":
        b, acc = _base(v.src)
        if b.kind == "iota" or acc[0] == "fixed":
            return b, acc
        if b.width not in (0, None):
            raise Unsupported("broadcast of a row")
        return b, ("bcast",)
    if v.kind == "group":
        b, acc = _base(v.src)
        if acc != ("lane", 0):
            raise Unsupported("grouped view of a view")
        return b, ("group", v.off)
    return v, ("lane", 0)


# ---------------------------------------------------------------------------
# record
# ---------------------------------------------------------------------------

_A = torch.ops.aten
_CMP = {
    _A.eq.Scalar: isa.OP_EQ, _A.eq.Tensor: isa.OP_EQ, _A.ne.Scalar: isa.OP_NE,
    _A.ne.Tensor: isa.OP_NE, _A.lt.Scalar: isa.OP_LT, _A.lt.Tensor: isa.OP_LT,
    _A.le.Scalar: isa.OP_LE, _A.le.Tensor: isa.OP_LE, _A.gt.Scalar: isa.OP_GT,
    _A.gt.Tensor: isa.OP_GT, _A.ge.Scalar: isa.OP_GE, _A.ge.Tensor: isa.OP_GE,
}
_BIN = {
    _A.bitwise_and.Tensor: isa.OP_AND, _A.bitwise_and.Scalar: isa.OP_AND,
    _A.bitwise_or.Tensor: isa.OP_OR, _A.bitwise_or.Scalar: isa.OP_OR,
    _A.bitwise_xor.Tensor: isa.OP_XOR, _A.bitwise_xor.Scalar: isa.OP_XOR,
    _A.maximum.default: isa.OP_MAX, _A.minimum.default: isa.OP_MIN,
    _A.mul.Tensor: isa.OP_MUL, _A.mul.Scalar: isa.OP_MUL,
}
_FACTORY = (_A.zeros.default, _A.ones.default, _A.full.default, _A.zeros_like.default,
            _A.ones_like.default, _A.full_like.default, _A.scalar_tensor.default)
_IDENTITY = (_A.alias.default, _A.detach.default, _A.lift_fresh.default,
             _A.lift_fresh_copy.default)
#: kernels the walk calls and the shapes of what they return
_KERNEL_OUT = {
    "gather_rows": lambda vec, idx: [(idx.shape, torch.int32)],
    "segment_sum_rows": lambda val, seg, s: [((val.shape[0], s), torch.int32)],
    "set_count_rows": lambda q_org, *rest: [(q_org.shape, torch.int32)],
    "distinct_first_rows": lambda org, key, mask: [(org.shape, torch.bool)],
    "seg_min_max_rows": lambda seg, mask, hi, lo, s: [((seg.shape[0], s), torch.int32)] * 4,
}
_RANGE = {torch.bool: (0, 1), torch.int8: (-128, 127), torch.int32: (_I32_MIN, _I32_MAX)}


class Recorder(TorchDispatchMode):
    """Notes every aten op of a walk over `D_REC` rows as tape values
    and instructions, and every kernel call as a barrier."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here is compiled: without the wrapper that keeps the
        # compiler out of __torch_dispatch__, a recording neither imports
        # the compiler nor pays the wrapper on every op
        return False

    def __init__(self):
        super().__init__()
        self.vals: Dict[int, Val] = {}
        self.keep: list = []  # the tensors behind `vals`' ids stay alive
        self.instrs: List[Instr] = []
        self.barriers: List[Barrier] = []
        self.order: list = []  # instructions and barriers, recorded order
        self.fnvar_next = False
        # the tensors bound to each value, and the views of each value
        self.aliases: Dict[int, List[int]] = {}
        self.views: Dict[int, set] = {}

    # -- values ------------------------------------------------------------

    def bind(self, t: torch.Tensor, v: Val) -> Val:
        self.vals[id(t)] = v
        self.keep.append(t)
        self.aliases.setdefault(id(v), []).append(id(t))
        if v.kind in ("slice", "col", "bcast", "group"):
            self.views.setdefault(id(v.src), set()).add(id(v))
        return v

    def val(self, x) -> Val:
        if isinstance(x, torch.Tensor):
            v = self.vals.get(id(x))
            if v is not None:
                return v
            if x.dim() == 0 and x.device.type == "cpu":
                # a Python number wrapped by torch
                return self._const(x.item(), x.dtype, None)
            raise Unsupported(f"a tensor the tape did not make ({tuple(x.shape)})")
        if isinstance(x, bool):
            return self._const(int(x), torch.bool, None)
        if isinstance(x, int):
            return self._const(x, torch.int64, None)
        raise Unsupported(f"operand {type(x).__name__}")

    @staticmethod
    def _const(value, dtype, width) -> Val:
        if isinstance(value, float) or dtype.is_floating_point:
            raise Unsupported("a float operand")
        value = int(value)
        if not _I32_MIN <= value <= _I32_MAX:
            raise Unsupported("a constant beyond int32")
        v = Val("const", dtype, width, src=value)
        v.lo = v.hi = value
        return v

    @staticmethod
    def width_of(t: torch.Tensor):
        shape = tuple(t.shape)
        if len(shape) == 0:
            return None
        if shape[0] != D_REC:
            raise Unsupported(f"shape {shape}")
        if len(shape) == 1 or (len(shape) == 2 and shape[1] == 1):
            return 0
        if len(shape) == 2:
            return shape[1]
        raise Unsupported(f"shape {shape}")

    def emit(self, t, op, args, dtype=None) -> Val:
        dtype = dtype or t.dtype
        if dtype not in _DT:
            raise Unsupported(f"dtype {dtype}")
        width = self.width_of(t)
        if width is None:
            raise Unsupported("a scalar result")
        out = Val("ew", dtype, width)
        ins = Instr(op, dtype, width, args, out=out)
        out.instr = ins
        self._range(ins)
        self.instrs.append(ins)
        self.order.append(ins)
        return self.bind(t, out)

    def store(self, op, width, arg: Val, target: Val, tcol: int = 0, aux: int = 0) -> Instr:
        ins = Instr(op, target.dtype, width, [arg], aux=aux, target=target, tcol=tcol)
        self.instrs.append(ins)
        self.order.append(ins)
        return ins

    def _range(self, ins: Instr) -> None:
        """Bounds of a result; an int64 value must fit int32, which
        every register and memory slot holds."""
        out, op, a = ins.out, ins.op, ins.args
        lo, hi = _RANGE.get(ins.dtype, (None, None))
        if ins.dtype == torch.int64:
            if op == isa.OP_COPY:
                lo, hi = a[0].lo, a[0].hi
            elif op == isa.OP_WHERE:
                lo, hi = min(a[1].lo, a[2].lo), max(a[1].hi, a[2].hi)
            elif op in (isa.OP_MAX, isa.OP_MIN):
                lo, hi = min(a[0].lo, a[1].lo), max(a[0].hi, a[1].hi)
            elif op in (isa.OP_ADD, isa.OP_SUB):
                s = 1 if op == isa.OP_ADD else -1
                cands = [x + s * y for x in (a[0].lo, a[0].hi) for y in (a[1].lo, a[1].hi)]
                lo, hi = min(cands), max(cands)
            else:
                raise Unsupported("int64 arithmetic")
            if lo < _I32_MIN or hi > _I32_MAX:
                raise Unsupported("an int64 value beyond int32")
        out.lo, out.hi = lo, hi

    # -- kernels -----------------------------------------------------------

    def kernel(self, name: str):
        if name not in _KERNEL_OUT:
            raise Unsupported(f"kernel {name}")

        def call(*args):
            shapes = _KERNEL_OUT[name](*args)
            vargs = []
            for a in args:
                if isinstance(a, torch.Tensor):
                    vargs.append(self.val(a))
                elif isinstance(a, int) and a != D_REC:
                    vargs.append(a)
                else:
                    raise Unsupported(f"{name} argument {a!r}")
            with _disable_current_modes():
                outs = [torch.zeros(s, dtype=dt) for s, dt in shapes]
            bar = Barrier(name, vargs, [], self.fnvar_next)
            self.fnvar_next = False
            for t in outs:
                v = Val("bar", t.dtype, self.width_of(t))
                v.bar = bar
                bar.outs.append(self.bind(t, v))
            self.barriers.append(bar)
            self.order.append(bar)
            return outs[0] if len(outs) == 1 else tuple(outs)

        return call

    # -- aten --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.note(func, args, kwargs, out)
        return out

    def note(self, func, args, kwargs, out):
        A = _A
        if func in _IDENTITY:
            self.bind(out, self.val(args[0]))
            return
        if func in _FACTORY:
            if func == A.scalar_tensor.default:
                value = args[0]
            elif func in (A.zeros.default, A.zeros_like.default):
                value = 0
            elif func in (A.ones.default, A.ones_like.default):
                value = 1
            else:
                value = args[1]
            self.bind(out, self._const(value, out.dtype, self.width_of(out)))
            return
        if func == A.arange.start or func == A.arange.default:
            if out.dim() != 1 or out.dtype != torch.int32:
                raise Unsupported("arange")
            start = args[0] if func == A.arange.start else 0
            step = kwargs.get("step", args[2] if len(args) > 2 else 1)
            if step != 1:
                raise Unsupported("arange step")
            v = Val("iota", out.dtype, out.shape[0], src=int(start))
            v.lo, v.hi = int(start), int(start) + out.shape[0]
            self.bind(out, v)
            return
        if func == A.expand.default:
            src = self.val(args[0])
            w = self.width_of(out)
            if src.kind == "iota" and w == src.width:
                v = Val("bcast", src.dtype, w, src=src)
            elif src.width == 0 or src.width is None:
                v = Val("bcast", src.dtype, w, src=src)
            elif src.width == w:
                v = src
            else:
                raise Unsupported("expand")
            v.lo, v.hi = src.lo, src.hi
            self.bind(out, v)
            return
        if func == A.unsqueeze.default:
            src = self.val(args[0])
            if src.width != 0 or args[1] not in (1, -1):
                raise Unsupported("unsqueeze")
            self.bind(out, src)
            return
        if func == A.select.int:
            src = self.val(args[0])
            dim, idx = args[1], args[2]
            if src.kind == "lits" and dim == 0:
                v = Val("lit", torch.int32, None, src=int(idx))
            elif src.width and dim in (1, -1):
                w = src.width
                v = Val("col", src.dtype, 0, src=src, off=idx % w)
            else:
                raise Unsupported("select")
            v.lo, v.hi = src.lo, src.hi
            self.bind(out, v)
            return
        if func == A.slice.Tensor:
            src = self.val(args[0])
            dim = args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 else 0
            step = args[4] if len(args) > 4 else 1
            if step != 1 or src.width in (0, None):
                raise Unsupported("slice")
            if dim == 0:
                if tuple(out.shape) != (D_REC, src.width):
                    raise Unsupported("slice of rows")
                self.bind(out, src)
                return
            if dim not in (1, -1):
                raise Unsupported("slice")
            v = Val("slice", src.dtype, self.width_of(out), src=src,
                    off=(start or 0) % src.width if start and start < 0 else (start or 0))
            v.lo, v.hi = src.lo, src.hi
            self.bind(out, v)
            return
        if func == A.view.default or func == A._unsafe_view.default:
            src = self.val(args[0])
            shape = tuple(out.shape)
            if src.width is None and not shape:
                v = src
            elif len(shape) == 3 and src.width and shape[1] * shape[2] == src.width:
                v = Val("group", src.dtype, shape[1], src=src, off=shape[2])
            elif len(shape) == 2 and self.width_of(out) == src.width:
                v = src
            else:
                raise Unsupported("view")
            self.bind(out, v)
            return
        if func in (A._to_copy.default, A.clone.default):
            src = self.val(args[0])
            self.emit(out, isa.OP_COPY, [src])
            return
        if func in (A.where.self, A.where.ScalarSelf, A.where.ScalarOther, A.where.Scalar):
            c, a, b = (self.val(x) for x in args[:3])
            self.emit(out, isa.OP_WHERE, [c, a, b])
            return
        if func in _CMP:
            self.emit(out, _CMP[func], [self.val(args[0]), self.val(args[1])])
            return
        if func in _BIN:
            self.emit(out, _BIN[func], [self.val(args[0]), self.val(args[1])])
            return
        if func in (A.add.Tensor, A.sub.Tensor, A.add.Scalar, A.sub.Scalar):
            alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            if alpha != 1:
                raise Unsupported("alpha")
            op = isa.OP_ADD if func in (A.add.Tensor, A.add.Scalar) else isa.OP_SUB
            self.emit(out, op, [self.val(args[0]), self.val(args[1])])
            return
        if func in (A.bitwise_not.default, A.logical_not.default):
            src = self.val(args[0])
            op = isa.OP_LNOT if src.dtype == torch.bool or func == A.logical_not.default \
                else isa.OP_BNOT
            self.emit(out, op, [src])
            return
        if func == A.clamp.default:
            src = self.val(args[0])
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            if hi is not None:
                raise Unsupported("clamp max")
            self.emit(out, isa.OP_MAX, [src, self.val(lo)])
            return
        if func in (A.sum.dim_IntList, A.any.dim, A.any.dims):
            src = self.val(args[0])
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            dims = list(dims) if isinstance(dims, (list, tuple)) else [dims]
            if src.kind == "group" and dims in ([2], [-1]) and func == A.sum.dim_IntList:
                if out.dtype != torch.int32:
                    raise Unsupported("grouped sum dtype")
                self.emit(out, isa.OP_GROUP_SUM, [src])
                return
            if not src.width or dims not in ([1], [-1]):
                raise Unsupported("reduction")
            if func == A.sum.dim_IntList and out.dtype != torch.int32:
                raise Unsupported("sum dtype")
            red = Val("red", out.dtype, 0)
            red.lo, red.hi = (0, 1) if out.dtype == torch.bool else (_I32_MIN, _I32_MAX)
            op = isa.OP_RED_SUM if func == A.sum.dim_IntList else isa.OP_RED_OR
            red.instr = self.store(op, src.width, src, red)
            self.bind(out, red)
            return
        if func == A.stack.default:
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            parts = [self.val(t) for t in args[0]]
            if dim not in (1, -1) or any(p.width != 0 for p in parts):
                raise Unsupported("stack")
            o = Val("out", out.dtype, len(parts))
            o.parts = parts
            for r, p in enumerate(parts):
                self.store(isa.OP_COPY, 0, p, o, tcol=r)
            self.bind(out, o)
            return
        if func == A.cat.default:
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            parts = [self.val(t) for t in args[0]]
            if dim not in (1, -1) or any(not p.width for p in parts):
                raise Unsupported("cat")
            o = Val("cat", out.dtype, self.width_of(out))
            o.parts, col = [], 0
            for p in parts:
                o.parts.append(self.store(isa.OP_COPY, p.width, p, o, tcol=col))
                col += p.width
            self.bind(out, o)
            return
        if func in (A.fill_.Scalar, A.fill_.Tensor, A.copy_.default):
            dst = self.val(args[0])
            value = self.val(args[1])
            if dst.kind != "col" or dst.src.kind in ("slice", "col", "bcast", "group"):
                raise Unsupported("an in-place write")
            base = dst.src
            if self.views.get(id(base), set()) - {id(dst)} or base.width in (0, None):
                raise Unsupported("an in-place write to a value with views")
            at = Val("ew", torch.bool, base.width)
            at.instr = Instr(isa.OP_EQ, torch.bool, base.width,
                             [Val("iota", torch.int32, base.width, src=0),
                              self._const(dst.off, torch.int32, None)], out=at)
            at.lo, at.hi = 0, 1
            self.instrs.append(at.instr)
            self.order.append(at.instr)
            new = Val("ew", base.dtype, base.width)
            new.instr = Instr(isa.OP_WHERE, base.dtype, base.width, [at, value, base], out=new)
            self._range(new.instr)
            self.instrs.append(new.instr)
            self.order.append(new.instr)
            # every tensor bound to the value (aliases such as a detached
            # factory result) now reads the written one
            for tid in self.aliases.get(id(base), []):
                if self.vals.get(tid) is base:
                    self.vals[tid] = new
                    self.aliases.setdefault(id(new), []).append(tid)
            self.bind(out, dst)
            return
        raise Unsupported(f"aten op {func}")


# ---------------------------------------------------------------------------
# schedule, place and encode
# ---------------------------------------------------------------------------


class Launch:
    """One segment: its program's place in the tape's program, its lane
    width, registers, and the values behind its buffer slots."""

    __slots__ = ("start", "n_instr", "width", "n_regs", "bufs", "zero", "pos", "loads")

    def __init__(self):
        self.start = self.n_instr = self.width = self.n_regs = 0
        self.bufs: List[Val] = []
        # memory read more than once: key -> (register, width, first
        # reader, value, access)
        self.loads: Dict[tuple, tuple] = {}
        self.zero = False
        self.pos = 0


class LaunchStep(NamedTuple):
    """A launch of the tape kernel: its program's rows, lane width,
    registers, whether it zeroes the accumulators first, and where each
    of its buffers lies: ("in", column), ("env", kernel output) or
    ("out", walk output)."""
    start: int
    n_instr: int
    width: int
    n_regs: int
    zero: bool
    bufs: tuple


class KernelStep(NamedTuple):
    """A call of `guard_tpu_torch.kernels.<name>` with arguments that lie
    at ("in", column), ("env", kernel output), ("ws", row offset, width,
    dtype) or are ("int", value); its outputs join the env."""
    name: str
    fnvar: bool
    args: tuple
    outs: tuple


class Tape:
    """A walk at one node bucket: `steps` in order, each a LaunchStep or
    a KernelStep; `prog` the int32 program of every launch; `ws_row` and
    `zero_row` the workspace's and its accumulators' bytes a row."""

    def __init__(self, steps, prog, ws_row, zero_row, outs, n_instr, n_levels, choices=()):
        self.steps, self.prog = steps, prog
        self.ws_row, self.zero_row = ws_row, zero_row
        self.outs = outs
        self.n_instr, self.n_levels = n_instr, n_levels
        # the workspace slot each stored value took, by number
        self.choices = choices
        self._dev_prog: Dict[torch.device, torch.Tensor] = {}

    @property
    def launches(self) -> int:
        return sum(isinstance(s, LaunchStep) for s in self.steps)

    def kernel_calls(self, name: Optional[str] = None) -> int:
        return sum(isinstance(s, KernelStep) and name in (None, s.name) for s in self.steps)

    def program_on(self, device: torch.device) -> torch.Tensor:
        got = self._dev_prog.get(device)
        if got is None:
            got = torch.from_numpy(self.prog.astype(np.int32))
            if device.type != "cpu":
                got = got.to(device)
            self._dev_prog[device] = got
        return got


def _read_key(b: Val, acc) -> tuple:
    """What a read of `b` with access `acc` loads, alike for alike."""
    if b.kind == "lit":
        return ("lit", b.src)
    if b.kind == "iota":
        return ("iota", b.src, acc)
    return (id(b), acc)


def _cross(acc) -> bool:
    """A read of another lane's element: the value must be in memory, from
    a launch before."""
    return acc[0] in ("fixed", "group") or (acc[0] == "lane" and acc[1] != 0)


def _access_level(v: Val, acc) -> int:
    """The earliest level a launch may read `v` (no view) with access
    `acc`: a value of the same launch read in its own lane, else one a
    launch before wrote."""
    k = v.kind
    if k in ("const", "lit", "iota", "in"):
        return 0
    if k == "ew":
        return v.instr.level + (1 if _cross(acc) else 0)
    if k == "bar":
        return v.bar.level + 1
    if k in ("red", "cat"):
        return max(p.level for p in ([v.instr] if k == "red" else v.parts)) + 1
    raise Unsupported(f"read of {k}")


def _bar_level(v: Val) -> int:
    """The earliest boundary after which a kernel may read `v` whole."""
    if v.kind == "in":
        return -1
    if v.kind == "ew":
        return v.instr.level
    if v.kind == "bar":
        return v.bar.level
    if v.kind == "cat":
        return max(p.level for p in v.parts)
    raise Unsupported(f"a kernel reads {v.kind}")


def _direct(v: Val) -> bool:
    """A kernel may take `v` as it lies in memory: a whole value of its
    dtype."""
    return v.kind in ("in", "bar", "ew", "cat") and v.width


def _fits(v: Val, dtype) -> bool:
    lo, hi = _RANGE.get(dtype, (_I32_MIN, _I32_MAX))
    return lo <= v.lo and v.hi <= hi


def _simplify(rec: Recorder) -> None:
    """Two rewrites that change no value. A cast whose input's values all
    fit its dtype: its readers read the input instead. An instruction
    that repeats an earlier one (the same op and dtype over the same
    reads): its readers read the earlier result. Neither applies where a
    kernel reads the result (a kernel takes a tensor of its own), and no
    kernel call is dropped."""
    by_kernel = {id(a) for bar in rec.barriers for a in bar.args if isinstance(a, Val)}
    alias: Dict[int, Val] = {}
    seen: Dict[tuple, Val] = {}

    def resolve(v: Val) -> Val:
        while id(v) in alias:
            v = alias[id(v)]
        return v

    def key(v: Val):
        b, acc = _base(v)
        if b.kind == "const":
            return ("const", b.src)
        return (id(b), acc)

    for ins in rec.order:
        if not isinstance(ins, Instr):
            continue
        ins.args = [resolve(a) for a in ins.args]
        for a in ins.args:
            while a.kind in ("slice", "col", "bcast", "group"):
                a.src = resolve(a.src)
                a = a.src
        if ins.out is None or ins.target is not None or id(ins.out) in by_kernel:
            continue
        src = ins.args[0]
        if ins.op == isa.OP_COPY and src.kind in ("ew", "in", "bar", "const") \
                and _fits(src, ins.dtype):
            alias[id(ins.out)] = src
            ins.dead = True
            continue
        k = (ins.op, ins.dtype, ins.width) + tuple(key(a) for a in ins.args)
        if k in seen:
            alias[id(ins.out)] = seen[k]
            ins.dead = True
        else:
            seen[k] = ins.out
    for bar in rec.barriers:
        for a in bar.args:
            while isinstance(a, Val) and a.kind in ("slice", "col", "bcast", "group"):
                a.src = resolve(a.src)
                a = a.src
    rec.order = [s for s in rec.order if not (isinstance(s, Instr) and s.dead)]


_CMP_MASK = {isa.OP_EQ: isa.CMP_EQ, isa.OP_NE: isa.CMP_GT | isa.CMP_LT, isa.OP_LT: isa.CMP_LT,
             isa.OP_LE: isa.CMP_LT | isa.CMP_EQ, isa.OP_GT: isa.CMP_GT,
             isa.OP_GE: isa.CMP_GT | isa.CMP_EQ}
_BIT_MASK = {isa.OP_AND: isa.BIT_AND, isa.OP_OR: isa.BIT_OR, isa.OP_XOR: isa.BIT_XOR,
             isa.OP_BNOT: isa.BIT_NOT_A}
_ALU_CLASS = {isa.OP_MAX: isa.ALU_MAX, isa.OP_MIN: isa.ALU_MIN, isa.OP_MUL: isa.ALU_MUL,
              isa.OP_WHERE: isa.ALU_WHERE, isa.OP_ADD: isa.ALU_ADD,
              isa.OP_SUB: isa.ALU_ADD | isa.ALU_NEG_B}


def _alu(op: int, vals):
    """(aux, operands) of the kernel's ALU instruction for a tape op."""
    if op in _CMP_MASK:
        return isa.ALU_CMP | _CMP_MASK[op], vals
    if op == isa.OP_LNOT:
        return isa.ALU_CMP | isa.CMP_EQ, [vals[0], (True, 0), (True, 0)]
    if op in _BIT_MASK:
        return isa.ALU_BIT | _BIT_MASK[op], vals
    if op == isa.OP_COPY:
        return isa.ALU_ADD, [vals[0], (True, 0), (True, 0)]
    return _ALU_CLASS[op], vals


def compile_tape(rec: Recorder, outs) -> Tape:
    _simplify(rec)
    order = rec.order
    # kernel arguments that are views, constants or reductions are
    # copied into a value of their own first
    with_copies = []
    for st in order:
        if isinstance(st, Barrier):
            for i, a in enumerate(st.args):
                if isinstance(a, Val) and not _direct(a):
                    if not a.width:
                        raise Unsupported("a kernel reads a per-document value")
                    out = Val("ew", a.dtype, a.width)
                    out.instr = Instr(isa.OP_COPY, a.dtype, a.width, [a], out=out)
                    out.lo, out.hi = a.lo, a.hi
                    with_copies.append(out.instr)
                    rec.instrs.append(out.instr)
                    st.args[i] = out
        with_copies.append(st)
    order = with_copies
    # consumers
    instrs = [s for s in order if isinstance(s, Instr)]
    for s in order:
        reads = s.args if isinstance(s, Instr) else [a for a in s.args if isinstance(a, Val)]
        for a in reads:
            b, acc = _base(a)
            b.consumers.append((s, acc))
    # drop what nothing reads (store-only instructions are roots)
    live = set()
    for ins in reversed(instrs):
        if ins.target is None and not any(
                isinstance(c, Barrier) or id(c) in live for c, _ in ins.out.consumers):
            ins.dead = True
            continue
        live.add(id(ins))
    for ins in instrs:
        if ins.dead:
            for a in ins.args:
                b, _ = _base(a)
                b.consumers = [(c, acc) for c, acc in b.consumers if c is not ins]
    order = [s for s in order if not (isinstance(s, Instr) and s.dead)]
    instrs = [s for s in order if isinstance(s, Instr)]
    # earliest levels
    for s in order:
        if isinstance(s, Instr):
            lvl = 0
            for a in s.args:
                b, acc = _base(a)
                lvl = max(lvl, _access_level(b, acc))
            s.level = lvl
        else:
            lvl = -1
            for a in s.args:
                if isinstance(a, Val):
                    lvl = max(lvl, _bar_level(a))
            s.level = lvl
    # sink each value to the latest level its consumers allow
    for ins in reversed(instrs):
        if ins.target is not None or ins.out is None:
            continue
        latest = None
        for c, acc in ins.out.consumers:
            if isinstance(c, Barrier):
                lim = c.level
            else:
                lim = c.level - (1 if _cross(acc) else 0)
            latest = lim if latest is None else min(latest, lim)
        if latest is not None and latest > ins.level:
            ins.level = latest
    n_levels = max([s.level for s in order] + [0]) + 1
    # steps: each level's launch, then the kernels after it
    by_level: Dict[int, list] = {}
    bars_after: Dict[int, list] = {}
    for s in order:
        if isinstance(s, Instr):
            by_level.setdefault(s.level, []).append(s)
        else:
            bars_after.setdefault(s.level, []).append(s)
    steps: list = list(bars_after.get(-1, []))
    seg_instrs: List[List[Instr]] = []
    for lvl in range(n_levels):
        if by_level.get(lvl):
            steps.append(Launch())
            seg_instrs.append(by_level[lvl])
        steps.extend(bars_after.get(lvl, []))
    for i, s in enumerate(steps):
        s.pos = i
    for launch, seg in zip([s for s in steps if isinstance(s, Launch)], seg_instrs):
        for ins in seg:
            ins.pos = launch.pos
    # which values go to memory, and until which step they live
    for ins in instrs:
        v = ins.out
        if v is None:
            continue
        v.first = ins.pos
        v.last = ins.pos
        for c, acc in v.consumers:
            if c.pos != ins.pos or _cross(acc) or isinstance(c, Barrier):
                v.stored = True
            v.last = max(v.last, c.pos)
    for ins in instrs:
        t = ins.target
        if t is not None and t.kind in ("red", "cat") and t.first is None:
            t.first = min(p.pos for p in ([t.instr] if t.kind == "red" else t.parts))
            t.last = max([t.first] + [c.pos for c, _ in t.consumers])
    # registers: a linear scan over each launch, for the values it
    # computes and reads again and for the memory it reads more than
    # once (loaded once, before its first reader); a value that does not
    # fit is stored and read back by the lane that wrote it
    for launch, seg in zip([s for s in steps if isinstance(s, Launch)], seg_instrs):
        free = list(range(MAX_REGS - TEMPS))
        heapq.heapify(free)
        ends: list = []
        last_use: Dict[int, int] = {}
        reads: Dict[tuple, list] = {}  # key -> [first, last, readers, width, base, access]
        for i, ins in enumerate(seg):
            for a in ins.args:
                b, acc = _base(a)
                if b.kind == "ew" and b.instr.pos == ins.pos:
                    last_use[id(b)] = i
                elif b.kind != "const":
                    got = reads.setdefault(_read_key(b, acc), [i, i, 0, ins.width, b, acc])
                    got[1], got[2] = i, got[2] + 1
                    # loaded for the widest reader (0: every lane)
                    got[3] = 0 if not got[3] or not ins.width else max(got[3], ins.width)
        first_at: Dict[int, list] = {}
        for key, got in reads.items():
            if got[2] > 1:
                first_at.setdefault(got[0], []).append(key)
        used = 0
        for i, ins in enumerate(seg):
            while ends and ends[0][0] < i:
                _, r = heapq.heappop(ends)
                heapq.heappush(free, r)
            for key in first_at.get(i, ()):
                if free:
                    got = reads[key]
                    r = heapq.heappop(free)
                    launch.loads[key] = (r, got[3], i, got[4], got[5])
                    used = max(used, r + 1)
                    heapq.heappush(ends, (got[1], r))
            v = ins.out
            if v is None or id(v) not in last_use:
                continue
            if free:
                v.reg = heapq.heappop(free)
                used = max(used, v.reg + 1)
                heapq.heappush(ends, (last_use[id(v)], v.reg))
            else:
                v.stored = True
        # a launch reads at most `used` registers
        launch.n_regs = used
    # the workspace: reduction accumulators first (zeroed once a walk),
    # then every stored value in a slot of its width and element size
    # that is free for the steps it lives. Slots are reused only by values
    # of their own width and element size, so a tape placed at two node
    # widths makes the same choices at both (and its offsets are affine
    # in the node width, `Program`)
    zero_row = 0
    for ins in instrs:
        if ins.op in (isa.OP_RED_SUM, isa.OP_RED_OR) and ins.target.ws is None:
            ins.target.ws = zero_row
            zero_row += 16
    placed = [ins.out for ins in instrs if ins.out is not None and ins.out.stored]
    placed += [t for t in {id(i.target): i.target for i in instrs
                           if i.target is not None and i.target.kind == "cat"}.values()]
    for v in placed:
        # rows on 16-byte lines, as the kernels' vector loads want them
        v.wsize = -(-max(v.width, 1) * _ESIZE[_ET[v.dtype]] // 16) * 16
    placed.sort(key=lambda v: v.first)
    ws_row = zero_row
    free: Dict[tuple, list] = {}  # (width, element size) -> free slots
    active: list = []  # (last step, offset, size)
    slot_of: Dict[int, int] = {}  # offset -> the slot's number
    choices = []
    for v in placed:
        while active and active[0][0] < v.first:
            _, off, cls = heapq.heappop(active)
            heapq.heappush(free.setdefault(cls, []), (slot_of[off], off))
        cls = (v.width, _ESIZE[_ET[v.dtype]])
        if free.get(cls):
            _n, v.ws = heapq.heappop(free[cls])
        else:
            v.ws = ws_row
            slot_of[ws_row] = len(slot_of)
            ws_row += v.wsize
        choices.append(slot_of[v.ws])
        heapq.heappush(active, (v.last, v.ws, cls))
    # encode: each instruction becomes the kernel's loads of its memory
    # operands into temporaries, one ALU instruction (GROUP and the
    # reductions theirs), and a store where its value is stored
    words: List[int] = []
    launches = [s for s in steps if isinstance(s, Launch)]
    first_launch = True
    for launch, seg in zip(launches, seg_instrs):
        launch.width = max(max(ins.width for ins in seg), 1)
        slots: Dict[int, int] = {}
        temps = launch.n_regs  # TEMPS temporaries follow the values' registers
        used = [0]

        def slot(v: Val) -> int:
            if id(v) not in slots:
                if len(launch.bufs) >= MAX_BUFS:
                    raise Unsupported("a launch reads too many buffers")
                slots[id(v)] = len(launch.bufs)
                launch.bufs.append(v)
            return slots[id(v)]

        def memory(b: Val, acc) -> List[int]:
            et = isa.E_I32 if b.kind == "red" else _ET[b.dtype]
            stride = b.width if b.width else 1
            if b.kind in ("ew", "red", "cat"):
                mode, x = isa.M_WS, b.ws
            else:
                mode, x = isa.M_MEM, slot(b)
            if acc[0] == "lane":
                cm, z = isa.C_LANE, acc[1]
            elif acc[0] == "fixed":
                cm, z = isa.C_FIXED, acc[1]
            else:  # bcast, group
                cm, z = isa.C_FIXED if acc[0] == "bcast" else isa.C_LANE, 0
            if not b.width:
                cm, z = isa.C_FIXED, 0
            return [mode | (et << 8) | (cm << 16), x, stride, z]

        def emit(kind, dt, width, reg, aux, quad, imm=0) -> None:
            words.extend([kind | (dt << 8) | imm, width, reg, aux] + list(quad))

        def operand(a: Val, ins: Instr, t: int):
            """(immediate?, value or register) of an operand, loading it
            into temporary `t` where it lies in memory."""
            b, acc = _base(a)
            if b.kind == "const":
                return True, b.src
            if b.kind == "ew" and b.reg is not None and b.instr.pos == ins.pos \
                    and acc[0] in ("lane", "bcast") and (acc[0] == "bcast" or acc[1] == 0):
                return False, b.reg
            got = launch.loads.get(_read_key(b, acc))
            if got is not None:
                return False, got[0]
            return False, load(b, acc, ins.width, temps + t)

        def load(b: Val, acc, width: int, reg: int) -> int:
            if reg >= temps:
                used[0] = max(used[0], reg - temps + 1)
            if b.kind == "lit":
                quad = [isa.M_LIT, b.src, 0, 0]
            elif b.kind == "iota":
                quad = [isa.M_IOTA, b.src + (acc[1] if acc[0] == "lane" else 0), 0, 0]
            else:
                quad = memory(b, acc)
            emit(isa.I_LOAD, isa.DT_I32, width, reg, 0, quad)
            return reg

        first_loads: Dict[int, list] = {}
        for reg, width, first, b, acc in launch.loads.values():
            first_loads.setdefault(first, []).append((b, acc, width, reg))
        launch.start = len(words) // isa.TAPE_WORDS
        for i, ins in enumerate(seg):
            for b, acc, width, reg in first_loads.get(i, ()):
                load(b, acc, width, reg)
            t = ins.target if ins.target is not None else (
                ins.out if ins.out is not None and ins.out.stored else None)
            if ins.op == isa.OP_GROUP_SUM:
                b, acc = _base(ins.args[0])
                src = ins.out.reg if ins.out.reg is not None else temps + TEMPS - 1
                emit(isa.I_GROUP, isa.DT_I32, ins.width, src, ins.args[0].off, memory(b, acc))
            elif ins.op in (isa.OP_RED_SUM, isa.OP_RED_OR) or (
                    ins.op == isa.OP_COPY and ins.out is None):
                # a store-only instruction: its operand to its target, cut
                # to the target's dtype first where the two differ
                imm, src = operand(ins.args[0], ins, 0)
                cut = ins.op == isa.OP_COPY and _base(ins.args[0])[0].dtype != ins.dtype
                if imm or cut:
                    emit(isa.I_ALU, _DT[ins.dtype], ins.width, temps + TEMPS - 1, isa.ALU_ADD,
                         [src, 0, 0, 0], (isa.IMM_A if imm else 0) | isa.IMM_B | isa.IMM_C)
                    src = temps + TEMPS - 1
            else:
                vals = [operand(a, ins, k) for k, a in enumerate(ins.args)]
                vals += [(True, 0)] * (3 - len(vals))
                aux, vals = _alu(ins.op, vals)
                src = ins.out.reg if ins.out.reg is not None else temps + TEMPS - 1
                imm = sum(f for f, (i, _v) in zip((isa.IMM_A, isa.IMM_B, isa.IMM_C), vals) if i)
                emit(isa.I_ALU, _DT[ins.dtype], ins.width, src, aux, [v for _i, v in vals] + [0], imm)
            if src >= temps:
                used[0] = TEMPS
            if t is None:
                continue
            if t.kind == "red":
                kind = isa.I_RED_SUM if ins.op == isa.OP_RED_SUM else isa.I_RED_OR
                quad = [isa.M_WS | (isa.E_I32 << 8) | (isa.C_FIXED << 16), t.ws, 1, 0]
            elif t.kind == "out":
                kind = isa.I_STORE
                quad = [isa.M_MEM | (_ET[t.dtype] << 8) | (isa.C_FIXED << 16),
                        slot(t), t.width, ins.tcol]
            else:
                kind = isa.I_STORE
                cm = isa.C_LANE if ins.width else isa.C_FIXED
                quad = [isa.M_WS | (_ET[t.dtype] << 8) | (cm << 16), t.ws,
                        t.width if t.width else 1, ins.tcol]
            emit(kind, isa.DT_I32, ins.width, src, 0, quad)
        launch.n_instr = len(words) // isa.TAPE_WORDS - launch.start
        launch.n_regs = temps + used[0]
        launch.zero = first_launch and zero_row > 0
        first_launch = False
    prog = np.asarray(words, dtype=np.int64)
    # the replay's steps: the values they touch by where they lie
    env: Dict[int, int] = {}

    def where(v) -> tuple:
        if not isinstance(v, Val):
            return ("int", v)
        if v.kind == "in":
            return ("in", v.src)
        if v.kind == "out":
            return ("out", outs.index(v))
        if v.kind == "bar":
            return ("env", env[id(v)])
        return ("ws", v.ws, v.width, v.dtype)

    plan = []
    for st in steps:
        if isinstance(st, Launch):
            plan.append(LaunchStep(st.start, st.n_instr, st.width, st.n_regs, st.zero,
                                   tuple(where(v) for v in st.bufs)))
            continue
        args = tuple(where(a) for a in st.args)
        for v in st.outs:
            env[id(v)] = len(env)
        plan.append(KernelStep(st.name, st.fnvar, args, tuple(env[id(v)] for v in st.outs)))
    return Tape(plan, prog, ws_row, zero_row, tuple((o.width, o.dtype) for o in outs),
                len(instrs), n_levels, tuple(choices))


# ---------------------------------------------------------------------------
# the recording run and the replay
# ---------------------------------------------------------------------------


#: a program is recorded at the first node width and its record copied
#: to the second; every number of its tape is affine in the width, so the
#: two give the tape of any width. A workspace row of e * (k * N + c)
#: bytes takes R(e * (k * N + c)) at both, R rounding up to 16, which is
#: e * k * N + R(e * c) there (e * k * N a multiple of 16): the derived
#: row is never short, at any N. (At an odd multiple of 8 a row of bytes
#: may then end on an 8-byte line; K2 takes its vector loads only where
#: its pointers lie on 16-byte lines.)
WIDTHS = (64, 128)


def _rewidth(rec: Recorder, outs):
    """A copy of a record made at WIDTHS[0] nodes as it reads at
    WIDTHS[1]: every node width (a value's, an instruction's, a cat's
    column offsets, a kernel's size argument; each a * N + b with |b| <
    N / 2 in a walk) becomes a * WIDTHS[1] + b. Constants, column and
    slice offsets, literal ids and the walk's outputs (one column a
    rule) stay as they are."""
    n0, n1 = WIDTHS

    def w(x):
        if x is None:
            return None
        a = (x + n0 // 2) // n0
        return a * n1 + x - a * n0

    vals: Dict[int, Val] = {}
    instrs: Dict[int, Instr] = {}
    bars: Dict[int, Barrier] = {}

    def val(v: Val) -> Val:
        got = vals.get(id(v))
        if got is None:
            src = val(v.src) if isinstance(v.src, Val) else v.src
            got = vals[id(v)] = Val(v.kind, v.dtype, v.width if v.kind == "out" else w(v.width),
                                    src=src, off=v.off)
            got.lo, got.hi = v.lo, v.hi
            if v.instr is not None:
                got.instr = instr(v.instr)
            if v.bar is not None:
                got.bar = bar(v.bar)
            if v.parts is not None:
                got.parts = [instr(p) if isinstance(p, Instr) else val(p) for p in v.parts]
        return got

    def instr(ins: Instr) -> Instr:
        got = instrs.get(id(ins))
        if got is None:
            cat = ins.target is not None and ins.target.kind == "cat"
            got = instrs[id(ins)] = Instr(ins.op, ins.dtype, w(ins.width), [], aux=ins.aux,
                                          tcol=w(ins.tcol) if cat else ins.tcol)
            got.args = [val(a) for a in ins.args]
            got.out = val(ins.out) if ins.out is not None else None
            got.target = val(ins.target) if ins.target is not None else None
        return got

    def bar(b: Barrier) -> Barrier:
        got = bars.get(id(b))
        if got is None:
            got = bars[id(b)] = Barrier(b.name, [], [], b.fnvar)
            got.args = [val(a) if isinstance(a, Val) else w(a) for a in b.args]
            got.outs = [val(o) for o in b.outs]
        return got

    copy = Recorder.__new__(Recorder)
    copy.order = [instr(st) if isinstance(st, Instr) else bar(st) for st in rec.order]
    copy.instrs = [instr(i) for i in rec.instrs]
    copy.barriers = [bar(b) for b in rec.barriers]
    return copy, [val(o) for o in outs]


def _signature(arrays: Dict[str, torch.Tensor], lits: torch.Tensor) -> tuple:
    return tuple((k, v.dtype) for k, v in arrays.items()) + (("lits", tuple(lits.shape)),)


def _trace(compiled, columns: Dict[str, torch.dtype], n_lits: int, width: int):
    """(record, outputs) of the eager walk over zero columns of `width`
    nodes and D_REC rows."""
    evaluate = walk.build_doc_evaluator(compiled)
    rec = Recorder()
    zeros = {}
    for k, dtype in columns.items():
        lo_hi = _RANGE.get(dtype)
        if lo_hi is None:
            raise Unsupported(f"column {k} of dtype {dtype}")
        t = torch.zeros((D_REC, width), dtype=dtype)
        val = Val("in", dtype, width, src=k)
        val.lo, val.hi = lo_hi
        rec.bind(t, val)
        zeros[k] = t
    lits = torch.zeros((n_lits,), dtype=torch.int32)
    rec.bind(lits, Val("lits", torch.int32, None))
    _TLS.recorder = rec
    try:
        with rec:
            got = evaluate(zeros, lits)
    finally:
        _TLS.recorder = None
    outs = [rec.vals.get(id(t)) for t in got]
    if any(o is None or o.kind != "out" for o in outs):
        raise Unsupported("the walk's outputs")
    return rec, outs


def _affine(x0, x1, path: str):
    """The pair of one number of two tapes as (a, b), value a * N + b, or
    the common value of anything else; Unsupported where they differ
    otherwise."""
    n0, n1 = WIDTHS
    if isinstance(x0, tuple):
        if not isinstance(x1, tuple) or len(x0) != len(x1) or type(x0) is not type(x1):
            raise Unsupported(f"tapes differ at {path}")
        items = [_affine(a, b, f"{path}.{i}") for i, (a, b) in enumerate(zip(x0, x1))]
        return type(x0)(*items) if hasattr(x0, "_fields") else tuple(items)
    if isinstance(x0, (int, np.integer)) and not isinstance(x0, bool):
        a, r = divmod(int(x1) - int(x0), n1 - n0)
        if r:
            raise Unsupported(f"tapes differ at {path}")
        return _Aff(a, int(x0) - a * n0)
    if x0 != x1:
        raise Unsupported(f"tapes differ at {path}")
    return x0


class _Aff(NamedTuple):
    a: int
    b: int


def _at(x, n: int):
    if isinstance(x, _Aff):
        return x.a * n + x.b
    if isinstance(x, tuple):
        items = [_at(v, n) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class Program:
    """A program's walk for every node width: the tapes compiled at
    WIDTHS from one recording, every number of which must be affine in
    the width, give the tape of any other width by evaluating each
    number there."""

    def __init__(self, compiled, columns: Dict[str, torch.dtype], n_lits: int):
        # the collector stays off meanwhile: a recording makes some ten
        # objects an op and frees none of them before its end
        collecting = gc.isenabled()
        gc.disable()
        try:
            first = _trace(compiled, columns, n_lits, WIDTHS[0])
            second = _rewidth(*first)
            t0, t1 = compile_tape(*first), compile_tape(*second)
        finally:
            if collecting:
                gc.enable()
        if t0.choices != t1.choices or len(t0.prog) != len(t1.prog):
            raise Unsupported("the tapes of two widths are placed apart")
        self.n_instr, self.n_levels = t0.n_instr, t0.n_levels
        self.steps = _affine(tuple(t0.steps), tuple(t1.steps), "steps")
        self.ws_row = _affine(t0.ws_row, t1.ws_row, "ws_row")
        self.zero_row = _affine(t0.zero_row, t1.zero_row, "zero_row")
        self.outs = _affine(t0.outs, t1.outs, "outs")
        n0, n1 = WIDTHS
        self.prog_a, rem = np.divmod(t1.prog - t0.prog, n1 - n0)
        if rem.any():
            raise Unsupported("a program word not affine in the width")
        self.prog_b = t0.prog - self.prog_a * n0
        self.tapes: Dict[int, Tape] = {}

    def tape(self, width: int) -> Tape:
        got = self.tapes.get(width)
        if got is None:
            prog = self.prog_a * width + self.prog_b
            if prog.min() < _I32_MIN or prog.max() > _I32_MAX:
                raise Unsupported("a program word beyond int32")
            got = Tape(_at(self.steps, width), prog, _at(self.ws_row, width),
                       _at(self.zero_row, width), _at(self.outs, width),
                       self.n_instr, self.n_levels)
            self.tapes[width] = got
        return got


class Replay:
    """The state of one replay of `tape` over `arrays`' rows: the
    workspace, the walk's outputs (`outs`, or new tensors) and the
    kernels' outputs so far. `run(step)` runs one step."""

    def __init__(self, tape: Tape, arrays: Dict[str, torch.Tensor], lits: torch.Tensor,
                 outs=None):
        first = arrays["node_kind"]
        self.tape, self.arrays, self.lits = tape, arrays, lits
        self.d, dev = first.shape[0], first.device
        self.prog = tape.program_on(dev)
        self.ws = torch.empty(max(self.d * tape.ws_row, 1), dtype=torch.uint8, device=dev)
        self.outs = outs if outs is not None else [
            torch.empty((self.d, w), dtype=dt, device=dev) for w, dt in tape.outs]
        self.env: list = []

    def tensor(self, at):
        """The tensor (or int) a step's argument or buffer names."""
        kind, d = at[0], self.d
        if kind == "in":
            return self.arrays[at[1]]
        if kind == "env":
            return self.env[at[1]]
        if kind == "out":
            return self.outs[at[1]]
        if kind == "int":
            return at[1]
        _k, off, w, dtype = at
        n = d * w * _ESIZE[_ET[dtype]]
        return self.ws[d * off: d * off + n].view(dtype).view(d, w)

    def run(self, step) -> None:
        if isinstance(step, LaunchStep):
            K.walk_segment(self.prog, step.start, step.n_instr,
                           [self.tensor(b) for b in step.bufs], self.ws, self.lits, self.d,
                           step.width, step.n_regs, self.d * self.tape.zero_row if step.zero else 0)
            return
        args = [self.tensor(a) for a in step.args]
        fn = getattr(K, step.name)
        if step.fnvar:
            before = K.LAUNCHES["gather_rows"]
            got = fn(*args)
            walk.FNVAR_STEPS["per_origin"] += 1
            walk.FNVAR_STEPS["k1_launches"] += K.LAUNCHES["gather_rows"] - before
        else:
            got = fn(*args)
        self.env.extend(got if isinstance(got, tuple) else (got,))


def replay(tape: Tape, arrays: Dict[str, torch.Tensor], lits: torch.Tensor):
    """The walk's (statuses, unsure) from the tape: its launches of the
    tape kernel and its kernel calls, in order, over as many rows at a
    time as MAX_WORKSPACE holds (the tape is generic in D)."""
    first = arrays["node_kind"]
    d, dev = first.shape[0], first.device
    rows = max(1, MAX_WORKSPACE // max(tape.ws_row, 1))
    if d <= rows:
        run = Replay(tape, arrays, lits)
        for step in tape.steps:
            run.run(step)
        return tuple(run.outs)
    outs = [torch.empty((d, w), dtype=dt, device=dev) for w, dt in tape.outs]
    for lo in range(0, d, rows):
        hi = min(d, lo + rows)
        run = Replay(tape, {k: v[lo:hi] for k, v in arrays.items()}, lits,
                     [o[lo:hi] for o in outs])
        for step in tape.steps:
            run.run(step)
    return tuple(outs)


#: each program's walks: {id(compiled): (weakref, {signature: Program
#: or the reason it could not be recorded})}, an entry dropped with its
#: program
_TAPES: Dict[int, tuple] = {}
_TAPES_LOCK = threading.Lock()
#: the device types whose walks replay the tape; on the CPU the eager
#: walk already runs the kernels' plain versions op by op
TAPE_DEVICES = ("cuda",)


def tapes_of(compiled) -> dict:
    key = id(compiled)
    with _TAPES_LOCK:
        got = _TAPES.get(key)
        if got is None or got[0]() is not compiled:
            ref = weakref.ref(compiled, lambda _r, key=key, tapes=_TAPES: tapes.pop(key, None))
            got = (ref, {})
            _TAPES[key] = got
        return got[1]


def tape_for(compiled, arrays: Dict[str, torch.Tensor], lits: torch.Tensor) -> Optional[Tape]:
    """The tape of `compiled` at these columns' node width: the program's
    walk recorded on first use (for every width at once), or None where
    the walk uses an op the tape does not cover (that reason is kept;
    any other error of the recording propagates, and nothing is kept)."""
    programs = tapes_of(compiled)
    sig = _signature(arrays, lits)
    got = programs.get(sig)
    if got is None:
        widths = {v.shape[1] if v.dim() == 2 else None for v in arrays.values()}
        try:
            if len(widths) != 1 or None in widths:
                raise Unsupported("columns of several widths")
            got = Program(compiled, {k: v.dtype for k, v in arrays.items()}, lits.shape[0])
        except Unsupported as e:
            got = str(e) or "unsupported"
        programs[sig] = got
    if isinstance(got, str):
        return None
    try:
        return got.tape(arrays["node_kind"].shape[1])
    except Unsupported:
        return None


def build_fused_evaluator(compiled, counters: Optional[dict] = None):
    """fn(arrays, lits) -> (statuses (D, R) int8, unsure (D, R) bool),
    as `build_doc_evaluator`'s: the tape's replay where the columns lie
    on a device of a type in TAPE_DEVICES and the program's tape covers
    its walk, else the eager walk. Each call adds one to `walks_fused`
    or `walks_eager` of `counters`."""
    eager = walk.build_doc_evaluator(compiled)

    def evaluate(arrays: Dict[str, torch.Tensor], lits: torch.Tensor):
        first = arrays["node_kind"]
        tape = None
        if first.device.type in TAPE_DEVICES and first.shape[0] > 0 and compiled.rules:
            tape = tape_for(compiled, arrays, lits)
        if counters is not None:
            counters["walks_fused" if tape is not None else "walks_eager"] += 1
        if tape is None:
            return eager(arrays, lits)
        return replay(tape, arrays, lits)

    return evaluate
