"""Scheduled matmul with a fused elementwise epilogue (kernel B1).

Counterpart of ``exprgrad_tpu/ops/matmul.py``.  The kernel is
``exprgrad_torch/csrc/matmul.cu``: ``C = epilogue(A @ B)`` with float32
accumulation, stored as ``[m, n]`` or transposed ``[n, m]``.
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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..utils import kernels

# kernel launches since the last reset; chip_smoke.py reads it to prove
# the main path ran through the kernel
launches = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATTERNS = ("row", "col", "full")

# Opcodes of the epilogue program (csrc/matmul.cu ``enum Op``): the ops
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


def _check(a, b, epilogue, extra):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("matmul operands must be rank-2")
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    n_extra = len(epilogue.patterns) if epilogue is not None else 0
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
    _check(a, b, epilogue, extra)
    value = a.double() @ b.double()
    if transpose_out:
        value = value.T
    if epilogue is not None:
        rows, cols = value.shape
        frame = [_frame_extra(x, p, rows, cols).double()
                 for x, p in zip(extra, epilogue.patterns)]
        value = _run_plain(epilogue, value, frame)
    return value.to(out_dtype or a.dtype)


def _program(epilogue: Optional[Epilogue], extra) -> kernels.EpiProgram:
    prog = kernels.EpiProgram()
    if epilogue is None:
        return prog
    if (len(epilogue.code) > kernels.EPI_MAX_CODE
            or len(epilogue.consts) > kernels.EPI_MAX_CONSTS
            or len(extra) > kernels.EPI_MAX_EXTRA):
        raise ValueError("epilogue program exceeds the kernel's tables")
    prog.n_code = len(epilogue.code)
    prog.n_extra = len(extra)
    for i, (op, dst, a, b, c) in enumerate(epilogue.code):
        prog.code[i][:] = [op | (dst << 8), a, b, c]
    for i, value in enumerate(epilogue.consts):
        prog.consts[i] = value
    for i, (arr, pattern) in enumerate(zip(extra, epilogue.patterns)):
        prog.extra_pattern[i] = PATTERNS.index(pattern)
        prog.extra[i] = arr.data_ptr()
    return prog


def matmul_impl(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
                epilogue: Optional[Epilogue] = None,
                extra: Sequence[torch.Tensor] = (),
                transpose_out: bool = False) -> torch.Tensor:
    """``epilogue(a @ b)`` as ``[m, n]``, or ``[n, m]`` when
    ``transpose_out`` (the DSL's ``c[x, y] += a[y, k] * b[k, x]``).

    CUDA tensors launch the kernel or raise: ``a`` and ``b`` contiguous,
    float32 or bfloat16 and of one dtype; ``out_dtype`` and every extra
    operand float32 or bfloat16, extras contiguous in ``out_dtype`` with
    the element count of their pattern.  CPU tensors run
    :func:`matmul_plain`."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype, epilogue, extra, transpose_out)
    _check(a, b, epilogue, extra)
    out_dtype = out_dtype or a.dtype
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise ValueError(
            f"the matmul kernel takes float32 or bfloat16 operands of one "
            f"dtype, not {a.dtype} and {b.dtype}")
    if out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the matmul kernel cannot store {out_dtype}")
    (m, k), n = a.shape, b.shape[1]
    rows, cols = (n, m) if transpose_out else (m, n)
    tensors = [("a", a), ("b", b)]
    for i, (arr, pattern) in enumerate(zip(extra, epilogue.patterns
                                           if epilogue else ())):
        _frame_extra(arr, pattern, rows, cols)
        if arr.dtype != out_dtype:
            raise ValueError(f"extra {i} is {arr.dtype}, not {out_dtype}")
        tensors.append((f"extra {i}", arr))
    for name, t in tensors:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((rows, cols), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out  # nothing to launch
    prog = _program(epilogue, extra)
    lib = kernels.load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.egt_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            int(transpose_out), _KERNEL_DTYPES[a.dtype],
            _KERNEL_DTYPES[out_dtype], prog, stream)
    kernels.check(err, "egt_matmul")
    global launches
    launches += 1
    return out


class _ScheduledMatmul(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp`` ``pallas_matmul``: the forward
    runs :func:`matmul_impl`; the backward is two plain matmuls
    (``_mm_bwd``), accumulated in float32 (float64 for float64
    operands)."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return matmul_impl(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        acc = torch.float64 if a.dtype == torch.float64 else torch.float32
        g = g.to(acc)
        da = torch.matmul(g, b.to(acc).T).to(a.dtype)
        db = torch.matmul(a.to(acc).T, g).to(b.dtype)
        return da, db, None


def scheduled_matmul(a: torch.Tensor, b: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """``out[m, n] = a[m, k] @ b[k, n]`` through the kernel (its plain
    version on the CPU), differentiable in ``a`` and ``b``.  The kernel
    picks its own block and guards ragged shapes."""
    return _ScheduledMatmul.apply(a, b, out_dtype)
