"""Deterministic text form of programs/targets/kernels.

Used by ``Model.emit_ir`` and by golden-file tests, mirroring the role of the
reference pretty-printer (exprgrad/irprint.nim).  The format itself is new:
it prints the *structured* kernel form that this compiler keeps all the way
to the XLA/Pallas backend.
"""

from __future__ import annotations

from .ir import (
    Expr,
    GenKind,
    Instr,
    Kernel,
    LinearIndex,
    Op,
    Program,
    ShapeConstrKind,
    ShapeConstraint,
    Target,
    TensorOp,
)

_IMMEDIATE_OPS = {Op.IDX, Op.SCALAR, Op.BOOL}


def fmt_reg(reg: int | None) -> str:
    return "none" if reg is None else f"r{reg}"


def fmt_tensor(tensor: int | None) -> str:
    return "none" if tensor is None else f"t{tensor}"


def fmt_instr(instr: Instr) -> str:
    head = f"{fmt_reg(instr.res)} = " if instr.res is not None else ""
    op = instr.op.value
    parts: list[str] = []
    if instr.op == Op.IDX:
        parts.append(str(instr.index_lit))
    elif instr.op == Op.SCALAR:
        parts.append(repr(instr.scalar_lit))
    elif instr.op == Op.BOOL:
        parts.append(str(instr.bool_lit).lower())
    if instr.tensor is not None:
        parts.append(fmt_tensor(instr.tensor))
    if instr.op == Op.SHAPE:
        parts.append(f"dim={instr.dim}")
    parts.extend(fmt_reg(a) for a in instr.args)
    return f"{head}{op} {', '.join(parts)}".rstrip()


def fmt_linear(index: LinearIndex) -> str:
    terms: list[str] = []
    for reg in sorted(index.factors):
        f = index.factors[reg]
        if f == 1:
            terms.append(fmt_reg(reg))
        elif f == -1:
            terms.append(f"-{fmt_reg(reg)}")
        else:
            terms.append(f"{f}*{fmt_reg(reg)}")
    if index.constant != 0 or not terms:
        terms.append(str(index.constant))
    body = " + ".join(terms).replace("+ -", "- ")
    if index.setup:
        setup = "; ".join(fmt_instr(i) for i in index.setup)
        return f"{{{setup} | {body}}}"
    return body


def fmt_tensor_op(op: TensorOp) -> str:
    dims = ", ".join(fmt_linear(d) for d in op.dims)
    brackets = ("{", "}") if op.is_raw else ("[", "]")
    sched = " cache" if op.schedule.cache else ""
    return f"{fmt_tensor(op.tensor)}{brackets[0]}{dims}{brackets[1]}{sched}"


def _emit_expr(lines: list[str], expr: Expr, indent: str) -> None:
    for instr in expr.instrs:
        lines.append(f"{indent}{fmt_instr(instr)}")


def fmt_kernel(kernel: Kernel, indent: str = "") -> str:
    lines: list[str] = []
    gen = kernel.generator
    if gen.kind != GenKind.NONE:
        extra = f" reshape={gen.reshape}" if gen.kind == GenKind.RESHAPE else ""
        lines.append(
            f"{indent}generator {gen.kind.value} {fmt_tensor(gen.tensor)}{extra}"
        )
        if kernel.write is not None:
            lines.append(f"{indent}write {fmt_tensor(kernel.write.tensor)}")
        return "\n".join(lines)

    if kernel.extern is not None:
        ext = kernel.extern
        attrs = ", ".join(f"{k}={v!r}" for k, v in sorted(ext.attrs.items()))
        inputs = ", ".join(fmt_tensor(t) for t in ext.inputs)
        out = f"[{ext.out_index}/{ext.nout}]" if ext.nout > 1 else ""
        lines.append(
            f"{indent}extern {ext.name}{out}({inputs})"
            + (f" {{{attrs}}}" if attrs else "")
        )
        if kernel.write is not None:
            lines.append(f"{indent}write: {fmt_tensor(kernel.write.tensor)} +=")
        if kernel.custom_grad is not None:
            lines.append(f"{indent}custom_grad:")
            for sub in kernel.custom_grad.kernels:
                lines.append(f"{indent}  kernel:")
                lines.append(fmt_kernel(sub, indent + "    "))
        return "\n".join(lines)

    if kernel.remat:
        lines.append(f"{indent}remat")
    if kernel.setup:
        lines.append(f"{indent}setup:")
        for instr in kernel.setup:
            lines.append(f"{indent}  {fmt_instr(instr)}")
    if kernel.loops:
        lines.append(f"{indent}loops:")
        for loop in kernel.loops:
            mode = {0: "", 1: " independent", 2: " parallel"}[int(loop.mode)]
            sched_bits = []
            if loop.schedule.tile:
                sched_bits.append(f"tile({loop.schedule.tile_size})")
            if loop.schedule.parallel:
                sched_bits.append("parallel")
            if loop.schedule.share_cache:
                sched_bits.append("share_cache")
            sched = (" " + ",".join(sched_bits)) if sched_bits else ""
            if loop.has_bounds:
                bounds = f" in [{fmt_linear(loop.start)}; {fmt_linear(loop.stop)})"
                if loop.step != 1:
                    bounds += f" step {loop.step}"
            else:
                bounds = " unbounded"
            lines.append(f"{indent}  {fmt_reg(loop.iter_reg)}{bounds}{mode}{sched}")
    if kernel.reads:
        lines.append(f"{indent}reads:")
        for read in kernel.reads:
            lines.append(f"{indent}  {fmt_reg(read.data)} = {fmt_tensor_op(read)}")
    if kernel.expr.instrs:
        lines.append(f"{indent}expr:")
        _emit_expr(lines, kernel.expr, indent + "  ")
    if kernel.write is not None:
        op = {"add": "+=", "max": "max=", "min": "min="}[
            kernel.write.accumulate
        ]
        lines.append(
            f"{indent}write: {fmt_tensor_op(kernel.write)} {op} "
            f"{fmt_reg(kernel.write.data)}"
        )
    if kernel.custom_grad is not None:
        lines.append(f"{indent}custom_grad:")
        for sub in kernel.custom_grad.kernels:
            lines.append(f"{indent}  kernel:")
            lines.append(fmt_kernel(sub, indent + "    "))
    return "\n".join(lines)


def fmt_shape_constraint(constr: ShapeConstraint) -> str:
    dest = fmt_tensor(constr.dest)
    if constr.kind == ShapeConstrKind.NONE:
        return f"{dest}: none"
    if constr.kind == ShapeConstrKind.RANK:
        return f"{dest}: rank {constr.rank}"
    if constr.kind == ShapeConstrKind.DIMS:
        dims = ", ".join(fmt_linear(d) for d in constr.dims)
        return f"{dest}: dims [{dims}]"
    if constr.kind == ShapeConstrKind.COPY:
        return f"{dest}: copy {fmt_tensor(constr.src)}"
    reads = []
    for tensor in sorted(constr.reads):
        per_dim = constr.reads[tensor]
        dims = ", ".join(
            "|".join(fmt_linear(i) for i in idxs) for idxs in per_dim
        )
        reads.append(f"{fmt_tensor(tensor)}[{dims}]")
    write = ", ".join(fmt_linear(d) for d in constr.write)
    return f"{dest}: linear reads({'; '.join(reads)}) write[{write}]"


def fmt_target(target: Target, indent: str = "") -> str:
    lines = [f"{indent}target {target.name!r} output={fmt_tensor(target.output)}:"]
    if target.shapes:
        lines.append(f"{indent}  shapes:")
        for constr in target.shapes:
            lines.append(f"{indent}    {fmt_shape_constraint(constr)}")
    for it, kernel in enumerate(target.kernels):
        lines.append(f"{indent}  kernel {it}:")
        lines.append(fmt_kernel(kernel, indent + "    "))
    return "\n".join(lines)


def fmt_program(program: Program, target: str | None = None) -> str:
    """Format the program IR; ``target`` restricts output to one target
    and the tensors it references (reference ``$`` on Program, ir.nim)."""
    names = sorted(program.targets) if target is None else [target]
    shown = (
        None
        if target is None
        else program.targets[target].tensors
    )
    lines = ["program:"]
    lines.append("  tensors:")
    for it, tensor in enumerate(program.tensors):
        if shown is not None and it not in shown:
            continue
        name = f" {tensor.name!r}" if tensor.name else ""
        shape = f" shape={tensor.shape}" if tensor.shape else ""
        lines.append(f"    t{it} = {tensor.kind.value}{name}{shape}")
    for name in names:
        lines.append(fmt_target(program.targets[name], "  "))
    return "\n".join(lines)
