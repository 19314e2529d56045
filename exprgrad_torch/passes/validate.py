"""IR validation: def-before-use checking (reference passes.nim:2678-2730)."""

from __future__ import annotations

from .. import ir
from ..errors import ValidationError
from ..ir import ALL_STAGES, Instr, Kernel, LinearIndex, Program


def _check_instrs(instrs: list[Instr], defined: set[int]) -> None:
    for instr in instrs:
        for arg in instr.args:
            if arg not in defined:
                raise ValidationError(f"register r{arg} is used before definition")
        if instr.res is not None:
            defined.add(instr.res)


def _check_linear(index: LinearIndex, defined: set[int]) -> None:
    _check_instrs(index.setup, defined)
    for reg in index.factors:
        if reg not in defined:
            raise ValidationError(f"register r{reg} is used before definition")


def _validate_kernel(kernel: Kernel) -> None:
    if kernel.generator.kind != ir.GenKind.NONE:
        return
    defined: set[int] = set()
    _check_instrs(kernel.setup, defined)
    # iterator registers are in scope for the whole nest: loop bounds may
    # reference other iterators (triangular loops), regardless of order
    for loop in kernel.loops:
        defined.add(loop.iter_reg)
    for loop in kernel.loops:
        _check_linear(loop.start, defined)
        _check_linear(loop.stop, defined)
    for read in kernel.reads:
        for dim in read.dims:
            _check_linear(dim, defined)
        assert read.data is not None
        defined.add(read.data)
    _check_instrs(kernel.expr.instrs, defined)
    if kernel.write is not None:
        for dim in kernel.write.dims:
            _check_linear(dim, defined)
        if kernel.write.data is not None and kernel.write.data not in defined:
            raise ValidationError(
                f"write data register r{kernel.write.data} is not defined"
            )


def _same_index(a: LinearIndex, b: LinearIndex) -> bool:
    return a.factors == b.factors and a.constant == b.constant


def _check_self_reads(program: Program, kernel: Kernel,
                      written: set) -> None:
    """Reject SHIFTED self-reads of FRESH result tensors.

    Both backends give every read a snapshot of the tensor's pre-kernel
    contents (whole-array semantics).  For a freshly zeroed RESULT
    tensor, ``h[i] = f(h[i - 1])`` therefore silently reads zeros — the
    user almost certainly wanted a sequential recurrence, which this
    compiler does not run inside one kernel (the reference's answer
    would depend on loop order, i.e. on the schedule: passes.nim
    reorderLoops).  Same-index self-reads (``w[i] = w[i] - lr * g[i]``),
    shifted reads of params/caches (Jacobi-style updates of live
    state), and shifted self-reads of a result an EARLIER kernel
    already populated (``written``) stay legal: their snapshot
    semantics are well-defined and backend-consistent.
    """
    if kernel.write is None:
        return
    wdef = program.tensors[kernel.write.tensor]
    from ..ir import TensorKind

    if wdef.kind != TensorKind.RESULT:
        return
    if kernel.write.tensor in written:
        return  # snapshot of a prior kernel's output: deterministic
    name = wdef.name or f"t{kernel.write.tensor}"
    for read in kernel.reads:
        if read.tensor != kernel.write.tensor:
            continue
        if len(read.dims) == len(kernel.write.dims) and all(
            _same_index(r, w)
            for r, w in zip(read.dims, kernel.write.dims)
        ):
            continue
        raise ValidationError(
            f"kernel reads its own output tensor {name!r} at an index "
            f"different from the one it writes: reads observe the "
            f"tensor's PRE-KERNEL contents (zeros for a fresh result), "
            f"not a sequential recurrence. Compute the shifted source "
            f"into a separate tensor first, or express the recurrence "
            f"through an extern scan (fun.extern; see layers.lstm/"
            f"gru/rnn_tanh for the built-in recurrent family)"
        )


def validate(program: Program) -> None:
    program.assert_pass("validate", preserves=ALL_STAGES)
    for target in program.targets.values():
        modes: dict[int, set[str]] = {}
        written: set[int] = set()
        for kernel in target.kernels:
            _validate_kernel(kernel)
            if kernel.generator.kind == ir.GenKind.NONE:
                _check_self_reads(program, kernel, written)
            if kernel.write is not None:
                written.add(kernel.write.tensor)
            if kernel.write is not None:
                modes.setdefault(kernel.write.tensor, set()).add(
                    kernel.write.accumulate
                )
        for tid, tensor_modes in modes.items():
            if len(tensor_modes) > 1:
                raise ValidationError(
                    f"tensor t{tid} is written with mixed accumulation modes "
                    f"{sorted(tensor_modes)} in target {target.name!r}"
                )
