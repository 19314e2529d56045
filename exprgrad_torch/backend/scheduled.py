"""Scheduled contractions: classifier, epilogue planner and lowering onto
kernel B1.

Counterpart of the matmul part of ``exprgrad_tpu/backend/pallasgen.py``:
``is_scheduled``, ``PallasMatmul`` (here :class:`ScheduledMatmul`, with
the same declines and ``why`` strings), ``_EpilogueStep``,
``_classify_step``, ``PallasEpilogueChain`` (here :class:`EpilogueChain`)
and ``plan_epilogue_fusions``.  A kernel ``out[y, x] += a[y, k] * b[k, x]``
(or the transposed store ``out[x, y]``) that carries a schedule runs
``exprgrad_torch/csrc/matmul.cu``, with the chain of single-consumer
elementwise kernels after it folded into the kernel's epilogue.

What differs from the TPU emitter:

* The block is the kernel's own (128x128, 32-deep k slices), not the user's
  tile: ``tile_for``'s sublane/lane alignment and VMEM budget are TPU
  rules.  The JAX emitter accepts every tile (it pads), and so does this
  one.
* The kernel guards ragged edges itself, so no operand is zero-padded
  and no product is sliced back.
* The epilogue is a register program (:class:`~exprgrad_torch.ops.matmul.
  Epilogue`) compiled from the folded kernels' instructions, where the
  TPU kernel traced a closure over ``eval_elementwise``.  Its ops are the
  ones ``eval_elementwise`` handles; a chain holding any other op, or
  too large for the kernel's program tables, is not folded
  (:func:`_classify_step` says why).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import ir
from ..ir import Kernel, Op
from ..ops.matmul import OPCODE, Epilogue, matmul_impl
from ..utils import kernels as _limits


def is_scheduled(kernel: Kernel) -> bool:
    """True when the user attached any schedule directive to the kernel."""
    return any(
        loop.schedule.tile or loop.schedule.parallel
        or loop.schedule.share_cache
        for loop in kernel.loops
    ) or any(r.schedule.cache for r in kernel.reads)


# elementwise ops an epilogue may contain: the set the JAX package's
# eval_elementwise evaluates (index, shape-query and array ops stay on
# the plain paths)
_EPILOGUE_OPS = {
    Op.SCALAR: "const", Op.BOOL: "const",
    Op.ADD: "add", Op.SUB: "sub", Op.MUL: "mul", Op.DIV: "div",
    Op.NEG: "neg", Op.SIN: "sin", Op.COS: "cos", Op.EXP: "exp",
    Op.POW: "pow", Op.SQRT: "sqrt", Op.LN: "ln", Op.LOG: "log",
    Op.LOG2: "log2", Op.LOG10: "log10", Op.EQ: "eq", Op.LT: "lt",
    Op.LE: "le", Op.AND: "and", Op.OR: "or", Op.SELECT: "select",
}


class ScheduledMatmul:
    """Schedule-driven tiled matmul: out[y,x] += a[y,k] * b[k,x].

    ``why`` carries the decline reason when ``ok`` is False, as in the JAX
    package's ``PallasMatmul``."""

    def __init__(self, lowering, kernel: Kernel):
        self.low = lowering
        self.kernel = kernel
        self.why = ""
        self.ok = self._classify()

    def _decline(self, why: str) -> bool:
        self.why = why
        return False

    def _classify(self) -> bool:
        low = self.low
        kernel = self.kernel
        write = kernel.write
        if write is None or write.is_raw or kernel.setup:
            return self._decline("raw write or setup instructions")
        if low.dtype == torch.float64:
            # the kernel accumulates in float32; float64 models keep the
            # exact einsum path
            return self._decline("float64 (MXU accumulates in f32)")
        if len(kernel.reads) != 2 or any(r.is_raw for r in kernel.reads):
            return self._decline("not a two-operand contraction")
        if any(r.dims and len(r.dims) != 2 for r in kernel.reads):
            return self._decline("operands are not rank-2")
        if len(write.dims) != 2:
            return self._decline("output is not rank-2")
        if not is_scheduled(kernel):
            return self._decline("no schedule")

        # expression: plain product of the two reads
        defs = {i.res: i for i in kernel.expr.instrs}
        if len(kernel.expr.instrs) != 1:
            return self._decline("expression is not a plain product")
        instr = defs.get(kernel.expr.res)
        if instr is None or instr.op != Op.MUL:
            return self._decline("expression is not a plain product")
        read_of = {r.data: r for r in kernel.reads}
        if set(instr.args) != set(read_of):
            return self._decline("expression is not a plain product")

        def axes_of(op) -> Optional[list[int]]:
            axes = []
            for dim in op.dims:
                axis = low._pure_iter(dim)
                if axis is None or low.starts[axis] != 0:
                    return None
                axes.append(axis)
            return axes

        w_axes = axes_of(write)
        a_read = read_of[instr.args[0]]
        b_read = read_of[instr.args[1]]
        a_axes, b_axes = axes_of(a_read), axes_of(b_read)
        if w_axes is None or a_axes is None or b_axes is None:
            return self._decline("indices are not plain iterators")
        if len(set(w_axes)) != 2 or len(low.sizes) != 3:
            return self._decline("not a [y,x] += a[y,k]*b[k,x] loop nest")
        # the contraction axis, then the reads oriented A [rows, k] and
        # B [k, cols] (operand transposes stay on the einsum path)
        k_candidates = set(a_axes) & set(b_axes)
        if len(k_candidates) != 1:
            return self._decline("no single shared contraction axis")
        k = next(iter(k_candidates))
        if k in w_axes:
            return self._decline("contraction axis appears in the output")
        if a_axes[1] == k and b_axes[0] == k:
            pass
        elif b_axes[1] == k and a_axes[0] == k:
            a_read, b_read = b_read, a_read
            a_axes, b_axes = b_axes, a_axes
        else:
            return self._decline(
                "operand layout transposed (einsum path handles it)"
            )
        y_axis, x_axis = a_axes[0], b_axes[1]
        if set(w_axes) != {y_axis, x_axis}:
            return self._decline("write axes do not match the operands")

        self.a_read, self.b_read = a_read, b_read
        self.y_axis, self.x_axis, self.k_axis = y_axis, x_axis, k
        # transposed store: c[x, y] += a[y, k] * b[k, x]
        self.transposed = w_axes == [x_axis, y_axis]
        self.m, self.n, self.k = (
            low.sizes[y_axis], low.sizes[x_axis], low.sizes[k]
        )
        return True

    def _operands(self, tensors: dict):
        """A ``[m, k]`` and B ``[k, n]``, contiguous: the loop ranges may
        cover less than the whole tensors.  Nothing is padded."""
        a = tensors[self.a_read.tensor][: self.m, : self.k]
        b = tensors[self.b_read.tensor][: self.k, : self.n]
        return a.contiguous(), b.contiguous()

    def _add_into(self, out, value):
        if tuple(out.shape) == tuple(value.shape):
            return out + value
        out = out.clone()
        rows, cols = value.shape
        out[:rows, :cols] += value
        return out

    def lower(self, tensors: dict):
        a, b = self._operands(tensors)
        value = matmul_impl(a, b, self.low.dtype,
                            transpose_out=self.transposed)
        return self._add_into(tensors[self.kernel.write.tensor], value)

    def lower_fused(self, tensors: dict, chain: "EpilogueChain"):
        """Matmul and the folded consumer chain as ONE kernel launch: the
        epilogue program runs on the accumulator in registers, so neither
        the product nor any chain intermediate is written to memory.
        Returns the chain's value in the stored frame."""
        a, b = self._operands(tensors)
        extra = [chain.prepare(tensors[tid], pat).contiguous()
                 for tid, pat in chain.extra]
        return matmul_impl(a, b, self.low.dtype, epilogue=chain.program,
                           extra=extra, transpose_out=self.transposed)


class _EpilogueStep:
    """One folded kernel of an epilogue chain.

    ``kind="map"``: a consumer kernel reading the running value (``src``)
    pointwise and writing a new tensor — out = f(acc, extras).
    ``kind="add"``: an additional accumulating writer of the running
    tensor (dense's bias kernel) — out = acc + f(extras).

    Two shapes are accepted in the [rows, cols] frame: rank-2 pointwise
    kernels (extras may be "row"/"col" rank-1 broadcasts or "full"
    same-shape tensors) and flat ``.raw`` elementwise kernels over
    rows*cols elements (extras are "full" tensors of the same size).
    """

    def __init__(self, kernel: Kernel, kind: str):
        self.kernel = kernel
        self.kind = kind
        self.read_pattern: dict[int, str] = {}  # data reg -> pattern
        self.extra: list[tuple[int, str]] = []


def _classify_step(low, kernel: Kernel, src: int, rows: int, cols: int,
                   kind: str) -> tuple[Optional[_EpilogueStep], str]:
    """Classify ``kernel`` as a foldable epilogue step in the [rows, cols]
    frame, reading the running value from tensor ``src`` (for
    kind="map"); returns ``(step, "")``, or ``(None, why)`` when it does
    not fold."""
    write = kernel.write
    if (
        write is None
        or kernel.setup
        or write.accumulate != "add"
        or kernel.generator.kind != ir.GenKind.NONE
        or kernel.custom_grad is not None
        or kernel.extern is not None
        or kernel.remat
    ):
        return None, "not a plain add-accumulated kernel"
    if not low._bounds_ok or low.dynamic_axes:
        return None, "empty or dynamic loop range"
    if any(s != 0 for s in low.starts):
        return None, "nonzero loop start"

    total = rows * cols
    raw = write.is_raw
    if raw:
        if len(kernel.loops) != 1 or low.sizes != [total]:
            return None, "raw kernel does not cover the frame"
        if low._pure_iter(write.dims[0]) != 0:
            return None, "raw write is not the loop iterator"
        out_shape = low.shapes[write.tensor]
        if int(np.prod(out_shape, dtype=np.int64)) != total:
            return None, "raw write does not cover the frame"
    else:
        if len(kernel.loops) != 2 or low.sizes != [rows, cols]:
            return None, "loop nest is not the [rows, cols] frame"
        if len(write.dims) != 2:
            return None, "output is not rank-2"
        if [low._pure_iter(d) for d in write.dims] != [0, 1]:
            return None, "write is not in frame order"
        if low.shapes[write.tensor] != [rows, cols]:
            return None, "output is not the frame"

    step = _EpilogueStep(kernel, kind)
    saw_src = False
    for read in kernel.reads:
        shape = low.shapes[read.tensor]
        if read.is_raw:
            if not raw or low._pure_iter(read.dims[0]) != 0:
                return None, "raw read is not pointwise"
            if int(np.prod(shape, dtype=np.int64)) != total:
                return None, "raw read does not cover the frame"
            pat = "full"
        else:
            if raw:
                return None, "indexed read in a raw kernel"
            axes = [low._pure_iter(d) for d in read.dims]
            if any(a is None for a in axes):
                return None, "read index is not a plain iterator"
            if axes == [0, 1] and shape == [rows, cols]:
                pat = "full"
            elif axes == [1] and shape == [cols]:
                pat = "row"
            elif axes == [0] and shape == [rows]:
                pat = "col"
            else:
                return None, "read is not a row, col or full pattern"
        if read.tensor == src and pat == "full" and kind == "map":
            step.read_pattern[read.data] = "acc"
            saw_src = True
            continue
        if read.tensor == src:
            return None, "add step reads the running tensor"
        step.read_pattern[read.data] = pat
        step.extra.append((read.tensor, pat))

    if kind == "map" and not saw_src:
        return None, "map step does not read the running value"
    defined = set(step.read_pattern)
    for instr in kernel.expr.instrs:
        if instr.op not in _EPILOGUE_OPS:
            return None, f"op {instr.op.value} is outside the epilogue set"
        if any(arg not in defined for arg in instr.args):
            return None, "expression references a loop iterator"
        if instr.res is not None:
            defined.add(instr.res)
    if kernel.expr.res not in defined:
        return None, "empty expression"
    return step, ""


def compile_epilogue(steps: list[_EpilogueStep]) -> tuple[
        Optional[Epilogue], str]:
    """The chain's register program: each step's instructions over fresh
    registers, then ``r0 = add r0, v`` for an add step or ``r0 = mov v``
    for a map step.  Returns ``(program, "")`` or ``(None, why)`` when
    the chain does not fit the kernel's tables."""
    code: list[tuple] = []
    consts: list[float] = []
    patterns: list[str] = []

    def const(value: float) -> int:
        if value not in consts:
            consts.append(value)
        return consts.index(value)

    for step in steps:
        env: dict[int, int] = {}
        nxt = 1  # registers 1.. are the step's temporaries

        def fresh() -> int:
            nonlocal nxt
            nxt += 1
            return nxt - 1

        for read in step.kernel.reads:
            pat = step.read_pattern[read.data]
            if pat == "acc":
                env[read.data] = 0
                continue
            env[read.data] = fresh()
            code.append((OPCODE["extra"], env[read.data], len(patterns), 0,
                         0))
            patterns.append(pat)
        for instr in step.kernel.expr.instrs:
            name = _EPILOGUE_OPS[instr.op]
            dst = fresh()
            if instr.op == Op.SCALAR:
                code.append((OPCODE[name], dst, const(float(instr.scalar_lit)),
                             0, 0))
            elif instr.op == Op.BOOL:
                code.append((OPCODE[name], dst,
                             const(1.0 if instr.bool_lit else 0.0), 0, 0))
            else:
                args = [env[a] for a in instr.args] + [0, 0, 0]
                code.append((OPCODE[name], dst, *args[:3]))
            if instr.res is not None:
                env[instr.res] = dst
        value = env[step.kernel.expr.res]
        if step.kind == "add":
            code.append((OPCODE["add"], 0, 0, value, 0))
        else:
            code.append((OPCODE["mov"], 0, value, 0, 0))
        if nxt > _limits.EPI_MAX_REGS:
            return None, (f"epilogue step needs {nxt} registers, the kernel "
                          f"has {_limits.EPI_MAX_REGS}")
    if len(code) > _limits.EPI_MAX_CODE:
        return None, (f"epilogue has {len(code)} steps, the kernel takes "
                      f"{_limits.EPI_MAX_CODE}")
    if len(consts) > _limits.EPI_MAX_CONSTS:
        return None, f"epilogue has {len(consts)} constants"
    if len(patterns) > _limits.EPI_MAX_EXTRA:
        return None, f"epilogue reads {len(patterns)} extra operands"
    return Epilogue(tuple(code), tuple(consts), tuple(patterns)), ""


class EpilogueChain:
    """A sequence of folded epilogue steps applied to the accumulator,
    and its register program."""

    def __init__(self, steps: list[_EpilogueStep], program: Epilogue,
                 final_tensor: int, rows: int, cols: int):
        self.steps = steps
        self.program = program
        self.final_tensor = final_tensor
        self.rows, self.cols = rows, cols
        self.extra: list[tuple[int, str]] = [
            e for step in steps for e in step.extra
        ]

    def prepare(self, arr, pattern: str):
        """Bring an extra operand into the 2-D frame layout."""
        if pattern == "row":
            return arr.reshape(1, -1)
        if pattern == "col":
            return arr.reshape(-1, 1)
        return arr.reshape(self.rows, self.cols)


def plan_epilogue_fusions(program, target, shapes, dtype, device,
                          policy=None):
    """Plan matmul+epilogue-chain fusions for one target.

    For every scheduled matmul the classifier accepts, folds into its
    epilogue (a) every additional accumulating writer of its output (bias
    kernels) and (b) the chain of single-consumer elementwise kernels
    downstream (activation, residual-style maps, rank-1 broadcasts).
    Transposed stores fold too.

    Returns ``(fused, skipped_kernels, skipped_tensors, declines)``:
    ``fused[i]`` is the (ScheduledMatmul, EpilogueChain) pair for the
    matmul at kernel index ``i``; ``skipped_kernels`` are the folded
    kernels' indices, ``skipped_tensors`` the intermediates that no longer
    materialize, and ``declines`` ``(kernel index, why)`` for each kernel
    that stopped a chain at classification.  Folding is only legal when
    each intermediate is a RESULT tensor, not the target output,
    written/read exclusively by the folded kernels.
    """
    from .torcheval import KernelLowering

    kernels = target.kernels
    reads_of: dict[int, list[int]] = {}
    writes_of: dict[int, list[int]] = {}
    for idx, kernel in enumerate(kernels):
        for tid in kernel.input_tensors():
            reads_of.setdefault(tid, []).append(idx)
        if kernel.write is not None:
            writes_of.setdefault(kernel.write.tensor, []).append(idx)

    def lowering_for(kernel):
        try:
            low = KernelLowering(program, kernel, shapes, dtype, device)
        except Exception:
            return None
        if not low._bounds_ok or low.dynamic_axes:
            return None
        return low

    fused: dict[int, tuple] = {}
    skipped_kernels: set[int] = set()
    skipped_tensors: set[int] = set()
    declines: list[tuple[int, str]] = []
    for idx in range(len(kernels) - 1):
        kernel = kernels[idx]
        if idx in skipped_kernels or kernel.write is None:
            continue
        if kernel.remat:
            # recompute kernels keep their own path (and remat stat)
            continue
        if kernel.write.accumulate != "add" or not is_scheduled(kernel):
            continue
        t1 = kernel.write.tensor
        if program.tensors[t1].kind != ir.TensorKind.RESULT:
            continue
        if t1 == target.output:
            continue
        low1 = lowering_for(kernel)
        if low1 is None:
            continue
        sm = ScheduledMatmul(low1, kernel)
        if not sm.ok:
            continue
        if policy is not None and not policy.routes_schedules:
            continue
        # frame: the value's [rows, cols] layout as stored
        rows, cols = (sm.n, sm.m) if sm.transposed else (sm.m, sm.n)

        steps: list[_EpilogueStep] = []
        folded: set[int] = set()      # kernel indices folded so far
        dropped: set[int] = set()     # intermediate tensors folded away

        def classify(kidx, cur, kind):
            low = lowering_for(kernels[kidx])
            if low is None:
                return None
            step, why = _classify_step(low, kernels[kidx], cur, rows, cols,
                                       kind)
            if step is None:
                declines.append((kidx, why))
            return step

        def extras_ready(step: _EpilogueStep, kidx: int) -> bool:
            """Folding moves the kernel from slot ``kidx`` to the matmul's
            slot ``idx``; every extra operand must already hold its final
            value there."""
            for tid, _pat in step.extra:
                for w in writes_of.get(tid, []):
                    if idx < w <= kidx:
                        return False
            return True

        cur = t1
        ok = True
        while True:
            at_t1 = cur == t1  # t1 must fold away fully or not at all
            writers = writes_of.get(cur, [])
            readers = reads_of.get(cur, [])
            expected = folded | ({idx} if at_t1 else set())
            own = [w for w in writers if w not in expected]
            # absorb additional accumulating writers (bias kernels); each
            # must precede every reader and not belong to another chain
            add_ok = True
            for w in own:
                step = (
                    classify(w, cur, "add")
                    if w not in skipped_kernels
                    and (not readers or w < min(readers))
                    else None
                )
                if step is None or not extras_ready(step, w):
                    add_ok = False
                    break
                steps.append(step)
                folded.add(w)
            if not add_ok or len(readers) != 1:
                ok = not at_t1
                break
            j = readers[0]
            consumer = kernels[j]
            step = (
                classify(j, cur, "map")
                if j > idx and j not in skipped_kernels
                else None
            )
            if step is None or not extras_ready(step, j):
                ok = not at_t1
                break
            steps.append(step)
            folded.add(j)
            dropped.add(cur)
            cur = consumer.write.tensor
            if (
                program.tensors[cur].kind != ir.TensorKind.RESULT
                or cur == target.output
            ):
                break  # cur is the final landing tensor; stop folding

        if not ok or not steps:
            continue
        epilogue, why = compile_epilogue(steps)
        if epilogue is None:
            declines.append((idx, why))
            continue
        fused[idx] = (sm, EpilogueChain(steps, epilogue, cur, rows, cols))
        skipped_kernels.update(folded)
        skipped_tensors.update(dropped)
    return fused, skipped_kernels, skipped_tensors, declines
