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
