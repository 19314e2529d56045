"""Scheduled matmul with a fused elementwise epilogue (kernel B1).

Counterpart of ``exprgrad_tpu/ops/matmul.py``.  The kernel is
``exprgrad_torch/csrc/matmul.cuh``: ``C = epilogue(A @ B)`` with float32
accumulation, stored as ``[m, n]`` or transposed ``[n, m]``, at one block
``(bm, bn, bk)`` of the lattice :data:`BLOCKS` (the TPU kernel's
``block_m``, ``block_n``, ``block_k``; :data:`DEFAULT_BLOCK` when none is
given).  Every block gives the same bits.
:func:`matmul_impl` launches it for CUDA tensors and raises on anything
it cannot take; for CPU tensors, and only for them, it runs
:func:`matmul_plain`, a float64 product followed by the same epilogue
evaluated with torch ops over the whole frame, which is also the oracle
the kernel is checked against on the card.  :func:`scheduled_matmul` is
the differentiable op (the JAX package's ``pallas_matmul``).

The epilogue is data (:class:`Epilogue`): where the TPU kernel traced a
Python closure into its body, the CUDA kernel interprets a small register
program per output element.  ``exprgrad_torch.backend.scheduled``
compiles a folded chain of elementwise kernels into one.

:func:`matmul_impl` goes through the ``torch.library`` op
``exprgrad_torch::matmul`` (CPU: :func:`matmul_plain`; CUDA: the kernel;
a fake implementation gives the output's shape and dtype), so
``torch.export`` keeps kernel B1 in an exported program.  The epilogue
program travels as the op's ``int[]`` and ``float[]`` arguments (the
steps five ints each, the constants, the extras' pattern indices) and
its extra operands as ``Tensor[]``, all None without an epilogue; the
block as ``int[]``, None for the default.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..utils import kernels

# kernel launches since the last reset; chip_smoke.py reads it to prove
# the main path ran through the kernel
launches = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/matmul.cu's MatmulArgs: a, b, c; m, n, k, transpose, in_dtype,
# out_dtype, bm, bn, bk; padded to the struct's 64 bytes
_MATMUL_ARGS = struct.Struct("<3Q9i4x")
# its fields' byte offsets and its size, which egt_matmul_args_offset
# must report before the first launch
_MATMUL_OFFSETS = (0, 8, 16, *range(24, 60, 4), _MATMUL_ARGS.size)
_layout_checked = False

# The blocks (bm, bn, bk) the kernel is built for: csrc/matmul.cuh's
# EGT_MATMUL_BLOCKS, in its order.  Warps of 64x32 output elements, so a
# block runs (bm / 64) * (bn / 32) warps.
BLOCKS = (
    (64, 64, 32), (64, 64, 64), (64, 128, 32), (64, 128, 64),
    (128, 64, 32), (128, 64, 64), (128, 128, 32), (128, 128, 64),
    (128, 256, 32), (128, 256, 64), (256, 128, 32), (256, 128, 64),
)
DEFAULT_BLOCK = (128, 128, 32)
_NO_EPILOGUE = kernels.EpiProgram()  # all zeros; the kernel only reads it
PATTERNS = ("row", "col", "full")

# Opcodes of the epilogue program (csrc/matmul.cuh ``enum Op``): the ops
# of the JAX package's ``eval_elementwise``, plus moves and loads.
OPS = (
    "mov", "const", "extra",
    "add", "sub", "mul", "div", "neg",
    "sin", "cos", "exp", "pow", "sqrt", "ln", "log", "log2", "log10",
    "eq", "lt", "le", "and", "or", "select",
)
OPCODE = {name: i for i, name in enumerate(OPS)}


@dataclass(frozen=True)
class Epilogue:
    """A register program run on each output element after the k loop.

    ``code`` holds ``(op, dst, a, b, c)`` steps over float registers;
    register 0 holds the accumulator on entry and is the result.  ``const``
    loads ``consts[a]``; ``extra`` loads extra operand ``a`` at the
    element's position by ``patterns[a]``: "row" ``[1, cols]``, "col"
    ``[rows, 1]`` or "full" ``[rows, cols]``, in the stored frame (the
    transposed one when the store is transposed).  Booleans are 1.0/0.0.
    """

    code: tuple
    consts: tuple = ()
    patterns: tuple = ()

    @functools.cached_property
    def flat(self) -> tuple:
        """``(code, consts, patterns)`` as the op's flat arguments: five
        ints a step, the constants, each extra's index in ``PATTERNS``
        (made once per program)."""
        return (tuple(x for step in self.code for x in step), self.consts,
                tuple(PATTERNS.index(p) for p in self.patterns))

    @staticmethod
    def from_flat(code, consts, patterns) -> Optional["Epilogue"]:
        """Inverse of :meth:`flat`; None for an empty program."""
        if not code and not consts and not patterns:
            return None
        return Epilogue(tuple(tuple(code[i:i + 5])
                              for i in range(0, len(code), 5)),
                        tuple(consts),
                        tuple(PATTERNS[p] for p in patterns))

    def text(self) -> str:
        """One line per step, for reading and for golden tests."""
        lines = [f"consts {list(self.consts)}",
                 f"extras {list(self.patterns)}"]
        for op, dst, a, b, c in self.code:
            name = OPS[op]
            if name == "const":
                args = f"#{a}"
            elif name == "extra":
                args = f"x{a}"
            elif name in ("mov", "neg", "sin", "cos", "exp", "sqrt", "ln",
                          "log2", "log10"):
                args = f"r{a}"
            elif name == "select":
                args = f"r{a}, r{b}, r{c}"
            else:
                args = f"r{a}, r{b}"
            lines.append(f"r{dst} = {name} {args}")
        return "\n".join(lines)


def _run_plain(epilogue: Epilogue, acc: torch.Tensor, extra) -> torch.Tensor:
    """Evaluate ``epilogue`` over the whole frame with torch ops."""
    reg = {0: acc}

    def truth(x):
        return x != 0

    def flag(x):
        return x.to(acc.dtype)

    for op, dst, a, b, c in epilogue.code:
        name = OPS[op]
        if name == "const":
            v = torch.full((), epilogue.consts[a], dtype=acc.dtype,
                           device=acc.device)
        elif name == "extra":
            v = extra[a]
        elif name == "mov":
            v = reg[a]
        elif name == "add":
            v = reg[a] + reg[b]
        elif name == "sub":
            v = reg[a] - reg[b]
        elif name == "mul":
            v = reg[a] * reg[b]
        elif name == "div":
            v = reg[a] / reg[b]
        elif name == "neg":
            v = -reg[a]
        elif name == "pow":
            v = torch.pow(reg[a], reg[b])
        elif name == "log":
            v = torch.log(reg[a]) / torch.log(reg[b])
        elif name == "eq":
            v = flag(reg[a] == reg[b])
        elif name == "lt":
            v = flag(reg[a] < reg[b])
        elif name == "le":
            v = flag(reg[a] <= reg[b])
        elif name == "and":
            v = flag(truth(reg[a]) & truth(reg[b]))
        elif name == "or":
            v = flag(truth(reg[a]) | truth(reg[b]))
        elif name == "select":
            v = torch.where(truth(reg[a]), reg[b], reg[c])
        else:
            v = getattr(torch, {"ln": "log"}.get(name, name))(reg[a])
        reg[dst] = v
    return torch.broadcast_to(reg[0], acc.shape)


def _frame_extra(arr: torch.Tensor, pattern: str, rows: int, cols: int):
    shape = {"row": (1, cols), "col": (rows, 1), "full": (rows, cols)}[pattern]
    if arr.numel() != shape[0] * shape[1]:
        raise ValueError(
            f"extra operand of pattern {pattern!r} has {arr.numel()} "
            f"elements, the frame [{rows}, {cols}] needs {shape}"
        )
    return arr.reshape(shape)


def _check(a, b, n_extra: int, extra):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("matmul operands must be rank-2")
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if len(extra) != n_extra:
        raise ValueError(
            f"{len(extra)} extra operands for an epilogue of {n_extra}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
                 epilogue: Optional[Epilogue] = None,
                 extra: Sequence[torch.Tensor] = (),
                 transpose_out: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``a @ b`` in float64,
    transposed when ``transpose_out``, then ``epilogue`` in float64 over
    the whole ``[rows, cols]`` frame, cast to ``out_dtype`` (``a``'s dtype
    by default)."""
    _check(a, b, len(epilogue.patterns) if epilogue is not None else 0,
           extra)
    value = a.double() @ b.double()
    if transpose_out:
        value = value.T
    if epilogue is not None:
        rows, cols = value.shape
        frame = [_frame_extra(x, p, rows, cols).double()
                 for x, p in zip(extra, epilogue.patterns)]
        value = _run_plain(epilogue, value, frame)
    return value.to(out_dtype or a.dtype)


@functools.lru_cache(maxsize=256)
def _program(code: tuple, consts: tuple,
             patterns: tuple) -> kernels.EpiProgram:
    """The kernel's ``EpiProgram`` for a flat epilogue (:meth:`Epilogue.
    flat`), packed once per program; a launch copies it and fills in the
    extras' pointers."""
    prog = kernels.EpiProgram()
    n_code = len(code) // 5
    if (n_code > kernels.EPI_MAX_CODE
            or len(consts) > kernels.EPI_MAX_CONSTS
            or len(patterns) > kernels.EPI_MAX_EXTRA):
        raise ValueError("epilogue program exceeds the kernel's tables")
    prog.n_code = n_code
    for i in range(n_code):
        op, dst, a, b, c = code[5 * i:5 * i + 5]
        prog.code[i][:] = [op | (dst << 8), a, b, c]
    for i, value in enumerate(consts):
        prog.consts[i] = value
    for i, pattern in enumerate(patterns):
        prog.extra_pattern[i] = pattern
    return prog


def _block(block) -> tuple:
    """The op's ``block`` argument as a member of :data:`BLOCKS` (None is
    :data:`DEFAULT_BLOCK`); raises on any other."""
    if block is None:
        return DEFAULT_BLOCK
    block = tuple(block)
    if block not in BLOCKS:
        raise ValueError(f"the matmul kernel has no block {block}; it is "
                         f"built for {BLOCKS}")
    return block


def _check_layout() -> None:
    """Hold ``_MATMUL_ARGS`` to the C struct's offsets and size."""
    global _layout_checked
    fn = kernels.load().egt_matmul_args_offset
    got = tuple(fn(i) for i in range(len(_MATMUL_OFFSETS)))
    if got != _MATMUL_OFFSETS:
        raise RuntimeError(f"MatmulArgs is laid out at {got} in the built "
                           f"kernels, the wrapper packs {_MATMUL_OFFSETS}")
    _layout_checked = True


def _matmul_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype, code,
                 consts, patterns, extra, transpose_out,
                 block=None) -> torch.Tensor:
    """The CUDA implementation of ``exprgrad_torch::matmul`` (the op's flat
    arguments, None for an empty program or the default block): checks
    what the kernel takes, or raises, then launches it."""
    code, consts, patterns, extra = (code or (), consts or (),
                                     patterns or (), extra or ())
    bm, bn, bk = _block(block)
    _check(a, b, len(patterns), extra)
    out_dtype = out_dtype or a.dtype
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise ValueError(
            f"the matmul kernel takes float32 or bfloat16 operands of one "
            f"dtype, not {a.dtype} and {b.dtype}")
    if out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the matmul kernel cannot store {out_dtype}")
    (m, k), n = a.shape, b.shape[1]
    rows, cols = (n, m) if transpose_out else (m, n)
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for i, (arr, pattern) in enumerate(zip(extra, patterns)):
        _frame_extra(arr, PATTERNS[pattern], rows, cols)
        if arr.dtype != out_dtype:
            raise ValueError(f"extra {i} is {arr.dtype}, not {out_dtype}")
        if arr.device != dev:
            raise ValueError(f"extra {i} is on {arr.device}, a on {dev}")
        if not arr.is_contiguous():
            raise ValueError(f"extra {i} must be contiguous")
    out = torch.empty((rows, cols), dtype=out_dtype, device=dev)
    if rows == 0 or cols == 0:
        return out  # nothing to launch
    if code or patterns:
        prog = kernels.EpiProgram.from_buffer_copy(
            _program(tuple(code), tuple(consts), tuple(patterns)))
        prog.n_extra = len(extra)
        for i, arr in enumerate(extra):
            prog.extra[i] = arr.data_ptr()
    else:
        prog = _NO_EPILOGUE
    if not _layout_checked:
        _check_layout()
    kernels.call("egt_matmul_packed", dev, _MATMUL_ARGS.pack(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        int(transpose_out), _KERNEL_DTYPES[a.dtype],
        _KERNEL_DTYPES[out_dtype], bm, bn, bk), ctypes.addressof(prog))
    global launches
    launches += 1
    return out


def _matmul_cpu(a, b, out_dtype, code, consts, patterns, extra,
                transpose_out, block=None):
    """The CPU implementation of ``exprgrad_torch::matmul``:
    :func:`matmul_plain`, the same at every block (checked, then
    unused)."""
    _block(block)
    return matmul_plain(a, b, out_dtype,
                        Epilogue.from_flat(code or (), consts or (),
                                           patterns or ()), extra or (),
                        transpose_out)


def _matmul_fake(a, b, out_dtype, code, consts, patterns, extra,
                 transpose_out, block=None):
    shape = ((b.shape[1], a.shape[0]) if transpose_out
             else (a.shape[0], b.shape[1]))
    return a.new_empty(shape, dtype=out_dtype or a.dtype)


_LIB = torch.library.Library("exprgrad_torch", "FRAGMENT")
_LIB.define("matmul(Tensor a, Tensor b, ScalarType? out_dtype, int[]? code, "
            "float[]? consts, int[]? patterns, Tensor[]? extra, "
            "bool transpose_out, int[]? block=None) -> Tensor")
_LIB.impl("matmul", _matmul_cpu, "CPU")
_LIB.impl("matmul", _matmul_cuda, "CUDA")
torch.library.register_fake("exprgrad_torch::matmul", _matmul_fake, lib=_LIB)
# the overload's C++ callable, as ``ops.attention._FLASH_FWD``
_MATMUL = torch.ops.exprgrad_torch.matmul.default._op


def matmul_impl(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
                epilogue: Optional[Epilogue] = None,
                extra: Sequence[torch.Tensor] = (),
                transpose_out: bool = False,
                block: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``epilogue(a @ b)`` as ``[m, n]``, or ``[n, m]`` when
    ``transpose_out`` (the DSL's ``c[x, y] += a[y, k] * b[k, x]``), by the
    kernel at ``block`` ``(bm, bn, bk)``, a member of :data:`BLOCKS`
    (None: :data:`DEFAULT_BLOCK`).

    CUDA tensors launch the kernel or raise: ``a`` and ``b`` contiguous,
    float32 or bfloat16 and of one dtype; ``out_dtype`` and every extra
    operand float32 or bfloat16, extras contiguous in ``out_dtype`` with
    the element count of their pattern.  CPU tensors run
    :func:`matmul_plain`.  Both go through the op
    ``exprgrad_torch::matmul``, and both raise on a block outside
    :data:`BLOCKS`."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no matmul kernel for {a.device}")
    block = list(block) if block is not None else None
    if epilogue is None and not extra:  # None boxes cheaper than []
        return _MATMUL(a, b, out_dtype, None, None, None, None,
                       transpose_out, block)
    code, consts, patterns = (epilogue.flat if epilogue is not None
                              else ((), (), ()))
    return _MATMUL(a, b, out_dtype, code, consts, patterns, list(extra),
                   transpose_out, block)


class _ScheduledMatmul(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp`` ``pallas_matmul``: the forward
    runs :func:`matmul_impl`; the backward is two plain matmuls
    (``_mm_bwd``), accumulated in float32 (float64 for float64
    operands)."""

    @staticmethod
    def forward(ctx, a, b, out_dtype, block):
        ctx.save_for_backward(a, b)
        return matmul_impl(a, b, out_dtype, block=block)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        acc = torch.float64 if a.dtype == torch.float64 else torch.float32
        g = g.to(acc)
        da = torch.matmul(g, b.to(acc).T).to(a.dtype)
        db = torch.matmul(a.to(acc).T, g).to(b.dtype)
        return da, db, None, None


def scheduled_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
                     block: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``out[m, n] = a[m, k] @ b[k, n]`` through the kernel at ``block``
    (its plain version on the CPU), differentiable in ``a`` and ``b``.
    The kernel guards ragged shapes at every block.  The counterpart of
    the JAX package's ``exprgrad_tpu.ops.pallas_matmul`` (its explicit
    ``block_m, block_n, block_k`` are ``block`` here), exported in its
    place by :mod:`exprgrad_torch.ops`."""
    return _ScheduledMatmul.apply(a, b, out_dtype, block)


# --- the einsum path's contractions on B1's Hopper mainloop --------------
#
# csrc/gemm_sm90.cu: a split pre-pass writes each operand's big and
# small TF32 planes K-major, then one wgmma GEMM over them writes
# ``alpha * a.b (+ c)`` at the output's strides.  :func:`plan_gemm` maps a
# two-operand einsum onto that GEMM; :func:`contract` runs it (the kernel
# on CUDA tensors, :func:`contract_plain` on CPU tensors).

# egt_gemm_tf32x3 launches since the last reset (one a contraction)
gemm_launches = 0

# half the GEMM's 128 x 128 tile (csrc/gemm_sm90.cu kBM, kBN): a product
# narrower than that either way stays with torch.einsum
_MIN_SIDE = 64
_MAX_AXES = 3  # axes a group may have (csrc/gemm_sm90.cu struct Axes)


@dataclass(frozen=True)
class GemmPlan:
    """A two-operand contraction as one GEMM, ``out[batch, m, n] = alpha *
    sum_k a[batch, m, k] b[batch, n, k]``.  Each field lists, per group,
    the dims of its tensor, in one order for all three: ``a``'s (batch,
    m, k), ``b``'s (batch, n, k) and ``out``'s (batch, m, n).  ``swap``:
    ``a`` is the einsum's second operand (``b`` holds the output's
    innermost axis).  Axes of size 1 are in no group."""

    a: tuple
    b: tuple
    out: tuple
    swap: bool

    @property
    def layout(self) -> str:
        """BLAS's two letters for the operands as a contiguous tensor
        stores them: ``a`` is ``n`` when its last dim is a k dim (stored
        [m, k]), ``t`` when an m dim ([k, m]); ``b`` is ``n`` when its
        last dim is an n dim (stored [k, n]), ``t`` when a k dim ([n,
        k]); ``b`` (batch) otherwise."""
        def letter(groups, plain, transposed):
            last = max((d for g in groups for d in g), default=None)
            return ("n" if last in groups[plain] else
                    "t" if last in groups[transposed] else "b")
        return letter(self.a, 2, 1) + letter(self.b, 1, 2)

    @functools.cached_property
    def flat(self) -> tuple:
        """The plan as the op's ``int[]``: ``swap``, then each of the nine
        groups (``a``'s, ``b``'s, ``out``'s) as its length and its dims
        (made once per plan)."""
        out = [int(self.swap)]
        for group in (*self.a, *self.b, *self.out):
            out += [len(group), *group]
        return tuple(out)


@functools.lru_cache(maxsize=256)
def _plan_from_flat(flat: tuple) -> GemmPlan:
    """Inverse of :attr:`GemmPlan.flat`."""
    groups, at = [], 1
    for _ in range(9):
        n = flat[at]
        groups.append(tuple(flat[at + 1:at + 1 + n]))
        at += 1 + n
    return GemmPlan(tuple(groups[0:3]), tuple(groups[3:6]),
                    tuple(groups[6:9]), bool(flat[0]))


def plan_gemm(operands, out, sizes):
    """``(plan, None)`` for the einsum whose operands read loop axes
    ``operands`` (two tuples) and whose output writes ``out``, loop axis
    ``i`` of extent ``sizes[i]``; ``(None, reason)`` where it is not one
    GEMM the kernel takes: other than two operands, an output axis in
    neither operand, no summed axis, an axis summed in one operand alone,
    a group of more than three axes, or m or n under half a tile."""
    if len(operands) != 2:
        return None, f"{len(operands)} operands"
    live = [tuple(x for x in ax if sizes[x] != 1) for ax in (*operands, out)]
    a_ax, b_ax, o_ax = live
    a, b, o = set(a_ax), set(b_ax), set(o_ax)
    if o - a - b:
        return None, "an output axis in neither operand"
    k = (a & b) - o
    if not k:
        return None, "no summed axis"
    if (a - b - o) or (b - a - o):
        return None, "an axis summed in one operand alone"
    swap = bool(o_ax) and o_ax[-1] in a - b
    if swap:
        a_ax, b_ax, a, b = b_ax, a_ax, b, a
    batch, m, n, kk = ([x for x in o_ax if x in a and x in b],
                       [x for x in o_ax if x in a and x not in b],
                       [x for x in o_ax if x in b and x not in a],
                       [x for x in a_ax if x in k])
    if max(len(g) for g in (batch, m, n, kk)) > _MAX_AXES:
        return None, f"a group of more than {_MAX_AXES} axes"
    extent = [math.prod(sizes[x] for x in g) for g in (m, n)]
    if min(extent) < _MIN_SIDE:
        return None, f"m or n under {_MIN_SIDE}"

    def dims(axes, *gs):
        return tuple(tuple(axes.index(x) for x in g) for g in gs)

    full = [tuple(ax) for ax in (*operands, out)]
    if swap:
        full[0], full[1] = full[1], full[0]
    return GemmPlan(dims(full[0], batch, m, kk), dims(full[1], batch, n, kk),
                    dims(full[2], batch, m, n), swap), None


def _group_sizes(shape, groups):
    return [math.prod(shape[d] for d in g) for g in groups]


def _as_gemm(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` as ``[batch, rows, k]`` (its dims of size 1 dropped)."""
    order = [d for g in groups for d in g]
    rest = [d for d in range(t.dim()) if d not in order]
    return t.permute(order + rest).reshape(_group_sizes(t.shape, groups))


def contract_plain(a: torch.Tensor, b: torch.Tensor, plan: GemmPlan,
                   out_shape, alpha: float = 1.0,
                   c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`contract`: the product in
    float64 (``torch.bmm`` over the groups), times ``alpha``, plus ``c``,
    cast to ``a``'s dtype."""
    if plan.swap:
        a, b = b, a
    value = torch.bmm(_as_gemm(a, plan.a).double(),
                      _as_gemm(b, plan.b).double().transpose(1, 2))
    order = [d for g in plan.out for d in g]
    rest = [d for d in range(len(out_shape)) if d not in order]
    order += rest
    value = value.reshape([out_shape[d] for d in order]).permute(
        [order.index(d) for d in range(len(out_shape))])
    value = alpha * value
    if c is not None:
        value = c.double() + value
    return value.to(a.dtype)


class _Axes(ctypes.Structure):
    """``struct Axes`` of csrc/gemm_sm90.cu: up to three axes of one
    group, innermost first."""

    _fields_ = [("n", ctypes.c_int64), ("size", ctypes.c_int64 * 3),
                ("stride", ctypes.c_int64 * 3)]


class _SplitArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("batch", ctypes.c_int64), ("rows", ctypes.c_int64),
                ("k", ctypes.c_int64), ("kp", ctypes.c_int64),
                ("x_batch", _Axes), ("x_rows", _Axes), ("x_k", _Axes)]


class _GemmArgs(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("d", ctypes.c_void_p), ("c", ctypes.c_void_p),
                ("batch", ctypes.c_int64), ("m", ctypes.c_int64),
                ("n", ctypes.c_int64), ("k", ctypes.c_int64),
                ("kp", ctypes.c_int64), ("alpha", ctypes.c_double),
                ("d_batch", _Axes), ("d_m", _Axes), ("d_n", _Axes)]


def _axes(t: torch.Tensor, dims) -> _Axes:
    """Dims ``dims`` (outer to inner) of ``t`` as the kernel's Axes: dims
    of size 1 dropped, neighbours that are one run in memory merged."""
    runs = []  # [size, stride], outer to inner
    for d in dims:
        size, stride = t.shape[d], t.stride(d)
        if size == 1:
            continue
        if runs and runs[-1][1] == size * stride:
            runs[-1] = [runs[-1][0] * size, stride]
        else:
            runs.append([size, stride])
    if len(runs) > _MAX_AXES:
        raise ValueError(f"dims {dims} of a tensor of strides {t.stride()} "
                         f"are more than {_MAX_AXES} runs")
    runs = runs[::-1] or [[1, 0]]
    out = _Axes(len(runs))
    for i, (size, stride) in enumerate(runs):
        out.size[i], out.stride[i] = size, stride
    return out


def _split(x: torch.Tensor, groups, batch: int, rows: int, k: int,
           kp: int) -> torch.Tensor:
    """The big and small TF32 planes of ``x`` K-major, ``[2, batch, rows,
    kp]``, by the split pre-pass."""
    planes = torch.empty((2, batch, rows, kp), dtype=torch.float32,
                         device=x.device)
    args = _SplitArgs(x.data_ptr(), planes.data_ptr(), batch, rows, k, kp,
                      *(_axes(x, g) for g in groups))
    kernels.call("egt_tf32_split", x.device, ctypes.addressof(args))
    return planes


def _contract_cuda(a, b, plan, out_shape, alpha, c) -> torch.Tensor:
    if plan.swap:
        a, b = b, a
    dev = a.device
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"the contraction kernel takes float32, "
                             f"{name} is {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
    batch, m, k = _group_sizes(a.shape, plan.a)
    n = _group_sizes(b.shape, plan.b)[1]
    out = torch.empty(tuple(out_shape), dtype=torch.float32, device=dev)
    if c is not None:
        if tuple(c.shape) != tuple(out_shape):
            raise ValueError(f"c is {tuple(c.shape)}, the output "
                             f"{tuple(out_shape)}")
        c = c if c.stride() == out.stride() else c.contiguous()
    if out.numel() == 0:
        return out
    kp = (k + 3) // 4 * 4
    pa = _split(a, plan.a, batch, m, k, kp)
    pb = _split(b, plan.b, batch, n, k, kp)
    args = _GemmArgs(pa.data_ptr(), pb.data_ptr(), out.data_ptr(),
                     c.data_ptr() if c is not None else None, batch, m, n,
                     k, kp, alpha, *(_axes(out, g) for g in plan.out))
    kernels.call("egt_gemm_tf32x3", dev, ctypes.addressof(args))
    global gemm_launches
    gemm_launches += 1
    return out


def _contract_op_cpu(a, b, plan, out_shape, alpha, c):
    return contract_plain(a, b, _plan_from_flat(tuple(plan)), out_shape,
                          alpha, c)


def _contract_op_cuda(a, b, plan, out_shape, alpha, c):
    return _contract_cuda(a, b, _plan_from_flat(tuple(plan)), out_shape,
                          alpha, c)


def _contract_fake(a, b, plan, out_shape, alpha, c):
    return a.new_empty(tuple(out_shape))


_LIB.define("contract(Tensor a, Tensor b, int[] plan, int[] out_shape, "
            "float alpha, Tensor? c) -> Tensor")
_LIB.impl("contract", _contract_op_cpu, "CPU")
_LIB.impl("contract", _contract_op_cuda, "CUDA")
torch.library.register_fake("exprgrad_torch::contract", _contract_fake,
                            lib=_LIB)
_CONTRACT = torch.ops.exprgrad_torch.contract.default._op


def contract(a: torch.Tensor, b: torch.Tensor, plan: GemmPlan, out_shape,
             alpha: float = 1.0,
             c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * einsum(a, b)`` (``+ c``) of shape ``out_shape`` by
    ``plan`` (:func:`plan_gemm`): on CUDA tensors the split pre-pass and
    B1's wgmma GEMM (float32 operands, float32 as split TF32; raises on
    anything else), on CPU tensors :func:`contract_plain`.  Both go
    through the op ``exprgrad_torch::contract`` (the plan as its
    ``int[]``), so ``torch.export`` keeps the kernel in an exported
    program."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no contraction kernel for {a.device}")
    return _CONTRACT(a, b, list(plan.flat), list(out_shape), float(alpha),
                     c)
