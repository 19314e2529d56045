"""Symbolic IR-level automatic differentiation.

This is the defining feature of the language: the backward pass is *derived
from the kernel IR itself* (not delegated to JAX autodiff), so any program a
user writes in the DSL gets gradients for free, including custom gradients.

Parity: reference ``generate`` pass (passes.nim:558-698) with per-instruction
``derive`` rules (passes.nim:383-517) and per-kernel gradient derivation
(passes.nim:519-549).

Scheme, for a forward kernel ``out[wi] += f(reads...)`` executed over a loop
nest: for every read ``r = t[ri]`` the gradient kernel is

    grad_t[ri] += (∂f/∂r evaluated at the forward values) * grad_out[wi]

executed over the *same* loop nest — a scatter-add when ``ri`` does not cover
the nest.  The TPU backend lowers these to MXU contractions / transposed
convolutions / segment-sums where the pattern allows.
"""

from __future__ import annotations

import math

from .. import ir
from ..errors import GradientError
from ..ir import (
    GenKind,
    Instr,
    Kernel,
    LinearIndex,
    Op,
    Program,
    ShapeConstrKind,
    ShapeConstrPriority,
    ShapeConstraint,
    Stage,
    TensorOp,
)
from .fold import dce_kernel


def _derive_instrs(
    instrs: list[Instr],
    kernel: Kernel,
    grad_regs: dict[int, int],
) -> list[Instr]:
    """Reverse-mode walk over straight-line scalar code.

    ``grad_regs`` maps forward register -> register holding dL/d(register).
    Emits the gradient-computing instructions and accumulates argument
    gradients, returning the new instruction list.
    """
    out: list[Instr] = []

    def alloc() -> int:
        return kernel.alloc_reg()

    def emit(op: Op, args: list[int], **kw) -> int:
        res = alloc()
        out.append(Instr(op=op, args=args, res=res, **kw))
        return res

    def scalar(value: float) -> int:
        return emit(Op.SCALAR, [], scalar_lit=value)

    for instr in reversed(instrs):
        if instr.res is None or instr.res not in grad_regs:
            continue
        g = grad_regs[instr.res]
        op = instr.op
        a = instr.args
        grad_args: list[int | None]

        if op == Op.ADD:
            grad_args = [g, g]
        elif op == Op.SUB:
            grad_args = [g, emit(Op.NEG, [g])]
        elif op == Op.MUL:
            grad_args = [emit(Op.MUL, [g, a[1]]), emit(Op.MUL, [g, a[0]])]
        elif op == Op.DIV:
            # d/dx (x/y) = 1/y ; d/dy (x/y) = -x/y^2
            ga = emit(Op.DIV, [g, a[1]])
            sq_y = emit(Op.MUL, [a[1], a[1]])
            g_over = emit(Op.DIV, [g, sq_y])
            neg_x = emit(Op.NEG, [a[0]])
            gb = emit(Op.MUL, [neg_x, g_over])
            grad_args = [ga, gb]
        elif op == Op.NEG:
            grad_args = [emit(Op.NEG, [g])]
        elif op == Op.EXP:
            grad_args = [emit(Op.MUL, [g, instr.res])]
        elif op == Op.SIN:
            c = emit(Op.COS, [a[0]])
            grad_args = [emit(Op.MUL, [c, g])]
        elif op == Op.COS:
            s = emit(Op.SIN, [a[0]])
            ns = emit(Op.NEG, [s])
            grad_args = [emit(Op.MUL, [ns, g])]
        elif op in (Op.LN, Op.LOG10, Op.LOG2):
            base = {Op.LN: 1.0, Op.LOG10: math.log(10.0), Op.LOG2: math.log(2.0)}[op]
            denom = a[0]
            if base != 1.0:
                factor = scalar(base)
                denom = emit(Op.MUL, [a[0], factor])
            grad_args = [emit(Op.DIV, [g, denom])]
        elif op == Op.LOG:
            # log(x, y) = ln(x)/ln(y)
            # d/dx = 1/(x ln y) ; d/dy = -ln(x)/(y ln(y)^2)
            log_y = emit(Op.LN, [a[1]])
            mul = emit(Op.MUL, [a[0], log_y])
            gx = emit(Op.DIV, [g, mul])
            log_x = emit(Op.LN, [a[0]])
            neg_log_x = emit(Op.NEG, [log_x])
            log_y_sq = emit(Op.MUL, [log_y, log_y])
            den = emit(Op.MUL, [a[1], log_y_sq])
            num = emit(Op.MUL, [g, neg_log_x])
            gy = emit(Op.DIV, [num, den])
            grad_args = [gx, gy]
        elif op == Op.SQRT:
            two = scalar(2.0)
            denom = emit(Op.MUL, [two, instr.res])
            grad_args = [emit(Op.DIV, [g, denom])]
        elif op == Op.POW:
            # d/da a^b = b * a^(b-1) ; d/db a^b = a^b * ln(a)
            one = scalar(1.0)
            bm1 = emit(Op.SUB, [a[1], one])
            p = emit(Op.POW, [a[0], bm1])
            pf = emit(Op.MUL, [a[1], p])
            ga = emit(Op.MUL, [g, pf])
            ln_a = emit(Op.LN, [a[0]])
            prod = emit(Op.MUL, [instr.res, ln_a])
            gb = emit(Op.MUL, [g, prod])
            grad_args = [ga, gb]
        elif op == Op.SELECT:
            zero = scalar(0.0)
            ga = emit(Op.SELECT, [a[0], g, zero])
            gb = emit(Op.SELECT, [a[0], zero, g])
            grad_args = [None, ga, gb]
        elif op == Op.DEBUG_SCALAR:
            grad_args = [g]  # identity
        elif op in (Op.TO_SCALAR, Op.TO_INDEX, Op.DEBUG_INDEX):
            grad_args = [None]
        elif not instr.args:
            continue  # literals and nullary queries carry no gradient
        else:
            raise GradientError(f"unable to derive {op.value}")

        if len(grad_args) != len(instr.args):
            raise GradientError(f"unable to derive {op.value}")

        for arg, ga in zip(instr.args, grad_args):
            if ga is None:
                continue
            if arg in grad_regs:
                grad_regs[arg] = emit(Op.ADD, [grad_regs[arg], ga])
            else:
                grad_regs[arg] = ga
    return out


def derive_kernel(kernel: Kernel, grad_tensors: dict[int, int]) -> list[Kernel]:
    """Derive one gradient kernel per forward read (passes.nim:519-549).

    Max-accumulation kernels get the subgradient: the incoming gradient is
    gated to the iterations whose value attained the maximum (the same rule
    the reference's maxpool custom gradient encodes by hand, dnn.nim:64-70).
    """
    assert kernel.write is not None
    base = kernel.copy()
    base.custom_grad = None
    grad_regs: dict[int, int] = {}

    write_grad = base.alloc_reg()
    base.reads.append(
        TensorOp(
            tensor=grad_tensors[kernel.write.tensor],
            dims=[d.copy() for d in kernel.write.dims],
            data=write_grad,
            is_raw=kernel.write.is_raw,
        )
    )
    assert kernel.write.data is not None
    if kernel.write.accumulate in ("max", "min"):
        # read the forward extremum and gate the gradient to the arg-max/min
        out_val = base.alloc_reg()
        base.reads.append(
            TensorOp(
                tensor=kernel.write.tensor,
                dims=[d.copy() for d in kernel.write.dims],
                data=out_val,
                is_raw=kernel.write.is_raw,
            )
        )
        is_arg = base.alloc_reg()
        zero = base.alloc_reg()
        gated = base.alloc_reg()
        base.expr.instrs.extend([
            Instr(op=Op.EQ, args=[kernel.write.data, out_val], res=is_arg),
            Instr(op=Op.SCALAR, scalar_lit=0.0, res=zero),
            Instr(op=Op.SELECT, args=[is_arg, write_grad, zero], res=gated),
        ])
        grad_regs[kernel.write.data] = gated
    else:
        grad_regs[kernel.write.data] = write_grad

    base.expr.instrs = base.expr.instrs + _derive_instrs(
        kernel.expr.instrs, base, grad_regs
    )

    out: list[Kernel] = []
    for read in kernel.reads:
        if read.data not in grad_regs:
            continue
        gk = base.copy()
        g = grad_regs[read.data]
        gk.expr.res = g
        gk.write = TensorOp(
            tensor=grad_tensors[read.tensor],
            is_raw=read.is_raw,
            dims=[d.copy() for d in read.dims],
            data=g,
        )
        dce_kernel(gk)
        out.append(gk)
    return out


def _copy_shape(target: ir.Target, dest: int, src: int) -> None:
    target.shapes.append(
        ShapeConstraint(
            ShapeConstrKind.COPY,
            dest=dest,
            priority=ShapeConstrPriority.INFERRED,
            src=src,
        )
    )


def _grad_seed_kernel(program: Program, target: ir.Target, loss: int) -> tuple[Kernel, int]:
    """grad_loss{i} = 1.0 for all i (passes.nim:574-606)."""
    grad_loss = program.alloc_tensor(ir.TensorDef(ir.TensorKind.RESULT))
    kernel = Kernel()
    value = kernel.alloc_reg()
    it = kernel.alloc_reg()
    length = kernel.alloc_reg()
    kernel.loops.append(
        ir.Loop(
            iter_reg=it,
            has_bounds=True,
            start=LinearIndex.of_const(0),
            stop=LinearIndex(
                setup=[Instr(op=Op.LEN, tensor=loss, res=length)],
                factors={length: 1},
            ),
            step=1,
        )
    )
    kernel.expr = ir.Expr(
        instrs=[Instr(op=Op.SCALAR, scalar_lit=1.0, res=value)], res=value
    )
    kernel.write = TensorOp(
        tensor=grad_loss, is_raw=True, dims=[LinearIndex.of_reg(it)], data=value
    )
    _copy_shape(target, grad_loss, loss)
    return kernel, grad_loss


def _reshape_kernel(program: Program, target: ir.Target, kernel: Kernel) -> Kernel:
    """Expand a reshape generator to a raw copy loop (passes.nim:643-696)."""
    src = kernel.generator.tensor
    assert src is not None and kernel.write is not None
    dest = kernel.write.tensor
    out = Kernel()
    data = out.alloc_reg()
    it = out.alloc_reg()
    length = out.alloc_reg()
    out.loops.append(
        ir.Loop(
            iter_reg=it,
            has_bounds=True,
            start=LinearIndex.of_const(0),
            stop=LinearIndex(
                setup=[Instr(op=Op.LEN, tensor=src, res=length)],
                factors={length: 1},
            ),
            step=1,
        )
    )
    out.reads.append(
        TensorOp(tensor=src, dims=[LinearIndex.of_reg(it)], data=data, is_raw=True)
    )
    out.expr = ir.Expr(res=data)
    out.write = TensorOp(
        tensor=dest, dims=[LinearIndex.of_reg(it)], data=data, is_raw=True
    )

    constr = ShapeConstraint(
        ShapeConstrKind.DIMS, dest=dest, priority=ShapeConstrPriority.INFERRED
    )
    known = 1
    for size in kernel.generator.reshape:
        if size >= 0:
            known *= size
    for size in kernel.generator.reshape:
        if size >= 0:
            constr.dims.append(LinearIndex.of_const(size))
        else:
            r_len, r_prod, r_div = 0, 1, 2
            constr.dims.append(
                LinearIndex(
                    setup=[
                        Instr(op=Op.LEN, tensor=src, res=r_len),
                        Instr(op=Op.IDX, index_lit=known, res=r_prod),
                        Instr(op=Op.IDX_DIV, args=[r_len, r_prod], res=r_div),
                    ],
                    factors={r_div: 1},
                )
            )
    target.shapes.append(constr)
    return out


def _apply_remat(
    program: Program,
    target: ir.Target,
    forward_kernels: list[Kernel],
    grad_kernels: list[Kernel],
    loss: int,
) -> list[Kernel]:
    """Rematerialize marked activations for the backward pass.

    The symbolic-autodiff analog of ``jax.checkpoint``: for every
    remat-marked tensor the gradient region reads, duplicate its forward
    kernels into the gradient region writing a fresh tensor, and redirect
    the gradient kernels' reads to it.  The duplicates are flagged
    ``kernel.remat`` with the LOSS tensor as their fence anchor — the
    backend bundles their operands with the loss value in one
    ``optimization_barrier`` (jax.checkpoint's scheme: the anchor depends
    on the whole forward, so the recompute cannot be hoisted into the
    forward pass, and CSE against the original computation would create
    a cycle).  Chained marks recompute from each other (a remat kernel
    reading another remat'd tensor reads the recomputed copy).

    Gradients themselves are unaffected: only VALUE reads move to the
    copies; grad tensors stay keyed by the original forward tensors.
    """
    read_by_grads: set[int] = set()
    for gk in grad_kernels:
        read_by_grads.update(gk.input_tensors())

    order: list[int] = []
    writers: dict[int, list[Kernel]] = {}
    for fk in forward_kernels:
        if fk.generator.kind != GenKind.NONE or fk.write is None:
            continue
        tid = fk.write.tensor
        if not program.tensors[tid].remat or tid not in read_by_grads:
            continue
        if tid not in writers:
            writers[tid] = []
            order.append(tid)
        writers[tid].append(fk)

    subs: dict[int, int] = {}
    recompute: list[Kernel] = []
    for tid in order:
        if any(k.extern is not None for k in writers[tid]):
            # extern results are memoized per execution: a duplicate call
            # would be deduplicated right back — no memory to save
            import warnings

            from ..errors import RematWarning

            name = program.tensors[tid].name or f"t{tid}"
            warnings.warn(
                f"remat() on {name!r} has no effect: it is produced by an "
                "extern op (whose per-execution memoization would "
                "deduplicate a recompute); mark the surrounding DSL "
                "kernels instead",
                RematWarning,
                stacklevel=2,
            )
            continue
        tdef = program.tensors[tid]
        new_tid = program.alloc_tensor(
            ir.TensorDef(
                ir.TensorKind.RESULT,
                name=(tdef.name or f"t{tid}") + ".remat",
            )
        )
        _copy_shape(target, new_tid, tid)
        for fk in writers[tid]:
            ck = fk.copy()
            ck.custom_grad = None
            ck.remat = True
            ir.substitute_tensors_kernel(ck, subs)
            ck.remat_anchor = loss
            assert ck.write is not None
            ck.write.tensor = new_tid
            recompute.append(ck)
        subs[tid] = new_tid

    if not subs:
        return grad_kernels
    for gk in grad_kernels:
        ir.substitute_tensors_kernel(gk, subs)
    return recompute + grad_kernels


def generate(program: Program) -> None:
    """Expand generator kernels: autodiff + reshape (passes.nim:558-698)."""
    program.assert_pass(
        "generate",
        produces={Stage.GENERATED},
        preserves={Stage.SHAPES, Stage.FOLDED, Stage.TENSOR_LOOKUPS},
    )

    for target in program.targets.values():
        it = 0
        while it < len(target.kernels):
            kernel = target.kernels[it]
            gen = kernel.generator
            if gen.kind == GenKind.BACKWARDS:
                assert gen.tensor is not None
                grad_tensors: dict[int, int] = {}
                grad_kernels: list[Kernel] = []

                seed, grad_loss = _grad_seed_kernel(program, target, gen.tensor)
                grad_kernels.append(seed)
                grad_tensors[gen.tensor] = grad_loss

                # outputs requested via grad(...) generators later in the target
                for later in target.kernels[it + 1:]:
                    if later.generator.kind == GenKind.GRADIENT:
                        assert later.generator.tensor is not None
                        assert later.write is not None
                        grad_tensors[later.generator.tensor] = later.write.tensor
                        _copy_shape(
                            target, later.write.tensor, later.generator.tensor
                        )

                for fwd in reversed(target.kernels[:it]):
                    if fwd.generator.kind != GenKind.NONE:
                        continue
                    if (
                        fwd.extern is not None
                        and fwd.write is not None
                        and fwd.write.tensor not in grad_tensors
                    ):
                        # opaque result never consumed on the loss path
                        # (e.g. the saved-logsumexp output of a fused
                        # attention, read only by its backward kernels)
                        continue
                    if fwd.extern is not None and fwd.custom_grad is None:
                        raise GradientError(
                            f"extern op {fwd.extern.name!r} has no "
                            "gradient: attach one with custom_grad + "
                            "extern_grads, or keep its result off the "
                            "loss path"
                        )
                    for tid in fwd.input_tensors():
                        if tid not in grad_tensors:
                            gt = program.alloc_tensor(
                                ir.TensorDef(ir.TensorKind.RESULT)
                            )
                            _copy_shape(target, gt, tid)
                            grad_tensors[tid] = gt
                    if fwd.custom_grad is not None:
                        cg = fwd.custom_grad
                        subs = dict(cg.subs)
                        for tensor, placeholder in cg.grad_placeholders.items():
                            real = cg.subs.get(tensor, tensor)
                            subs[placeholder] = grad_tensors[real]
                        for sub_kernel in reversed(cg.kernels):
                            gk = sub_kernel.copy()
                            ir.substitute_tensors_kernel(gk, subs)
                            grad_kernels.append(gk)
                    else:
                        grad_kernels.extend(derive_kernel(fwd, grad_tensors))

                grad_kernels = _apply_remat(
                    program, target, target.kernels[:it], grad_kernels,
                    gen.tensor,
                )
                for gk in grad_kernels:
                    gk.derived = True
                target.kernels[it: it + 1] = grad_kernels
                it += len(grad_kernels)
            elif gen.kind == GenKind.GRADIENT:
                del target.kernels[it]
            elif gen.kind == GenKind.RESHAPE:
                target.kernels[it] = _reshape_kernel(program, target, kernel)
                it += 1
            else:
                it += 1
