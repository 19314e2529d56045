"""Constant folding and algebraic simplification over kernel expressions.

Parity: reference ``propagateConstants`` (passes.nim:1575-1758) — constant
folding, x+0 / x*1 / x*0 / x/1 identities, select-on-constant — adapted to
the structured kernel form (the reference's trip-count-1 loop elimination
happens on inlined loops, which do not exist here; empty-range loops are
skipped by the backend at lowering time instead).

XLA performs the same simplifications during compilation; this pass exists
so the *IR* the user inspects (emit_ir, golden tests) and the trace handed
to XLA are already clean, and to keep interp-oracle runs cheap.
"""

from __future__ import annotations

import math
from typing import Optional, Union

from .. import ir
from ..ir import ALL_STAGES, Instr, Kernel, Op, Program

Const = Union[int, float, bool]


def _fold_instrs(instrs: list[Instr]) -> tuple[list[Instr], dict[int, int]]:
    """Fold constants; returns new instrs + register substitutions."""
    values: dict[int, Const] = {}
    is_scalar: dict[int, bool] = {}
    subs: dict[int, int] = {}
    out: list[Instr] = []

    def const_of(reg: int) -> Optional[Const]:
        return values.get(reg)

    for instr in instrs:
        instr = instr.copy()
        instr.args = [subs.get(a, a) for a in instr.args]
        op = instr.op
        args = instr.args
        cvals = [const_of(a) for a in args]
        folded: Optional[Const] = None
        replace_reg: Optional[int] = None

        def is_zero(v):
            return v is not None and not isinstance(v, bool) and v == 0

        def is_one(v):
            return v is not None and not isinstance(v, bool) and v == 1

        if op == Op.IDX:
            folded = instr.index_lit
        elif op == Op.SCALAR:
            folded = instr.scalar_lit
        elif op == Op.BOOL:
            folded = instr.bool_lit
        elif op == Op.ADD:
            if is_zero(cvals[0]):
                replace_reg = args[1]
            elif is_zero(cvals[1]):
                replace_reg = args[0]
            elif cvals[0] is not None and cvals[1] is not None:
                folded = cvals[0] + cvals[1]
        elif op == Op.SUB:
            if is_zero(cvals[1]):
                replace_reg = args[0]
            elif cvals[0] is not None and cvals[1] is not None:
                folded = cvals[0] - cvals[1]
        elif op == Op.MUL:
            if is_zero(cvals[0]) or is_zero(cvals[1]):
                folded = 0.0 if isinstance(
                    cvals[0] if is_zero(cvals[0]) else cvals[1], float
                ) else 0
            elif is_one(cvals[0]):
                replace_reg = args[1]
            elif is_one(cvals[1]):
                replace_reg = args[0]
            elif cvals[0] is not None and cvals[1] is not None:
                folded = cvals[0] * cvals[1]
        elif op == Op.DIV:
            if is_one(cvals[1]):
                replace_reg = args[0]
            elif (
                cvals[0] is not None and cvals[1] is not None and cvals[1] != 0
            ):
                folded = cvals[0] / cvals[1]
        elif op == Op.NEG:
            if cvals[0] is not None and not isinstance(cvals[0], bool):
                folded = -cvals[0]
        elif op == Op.SELECT:
            if isinstance(cvals[0], bool):
                replace_reg = args[1] if cvals[0] else args[2]
            elif args[1] == args[2]:
                replace_reg = args[1]
        elif op in (Op.EQ, Op.LT, Op.LE):
            if cvals[0] is not None and cvals[1] is not None:
                folded = {
                    Op.EQ: cvals[0] == cvals[1],
                    Op.LT: cvals[0] < cvals[1],
                    Op.LE: cvals[0] <= cvals[1],
                }[op]
        elif op == Op.AND:
            if cvals[0] is False or cvals[1] is False:
                folded = False
            elif cvals[0] is True:
                replace_reg = args[1]
            elif cvals[1] is True:
                replace_reg = args[0]
        elif op == Op.OR:
            if cvals[0] is True or cvals[1] is True:
                folded = True
            elif cvals[0] is False:
                replace_reg = args[1]
            elif cvals[1] is False:
                replace_reg = args[0]
        elif op in (Op.SQRT, Op.EXP, Op.LN, Op.SIN, Op.COS):
            if isinstance(cvals[0], float):
                try:
                    folded = {
                        Op.SQRT: math.sqrt,
                        Op.EXP: math.exp,
                        Op.LN: math.log,
                        Op.SIN: math.sin,
                        Op.COS: math.cos,
                    }[op](cvals[0])
                except ValueError:
                    folded = None
        elif op == Op.POW:
            if isinstance(cvals[0], float) and isinstance(cvals[1], float):
                try:
                    folded = math.pow(cvals[0], cvals[1])
                except ValueError:
                    folded = None

        if replace_reg is not None and instr.res is not None:
            subs[instr.res] = replace_reg
            if replace_reg in values:
                values[instr.res] = values[replace_reg]
            continue

        if folded is not None and instr.res is not None:
            values[instr.res] = folded
            if isinstance(folded, bool):
                instr = Instr(op=Op.BOOL, bool_lit=folded, res=instr.res)
            elif isinstance(folded, float):
                instr = Instr(op=Op.SCALAR, scalar_lit=folded, res=instr.res)
            else:
                instr = Instr(op=Op.IDX, index_lit=folded, res=instr.res)
        out.append(instr)
    return out, subs


def simplify_kernel(kernel: Kernel) -> None:
    if kernel.generator.kind != ir.GenKind.NONE:
        return
    kernel.expr.instrs, subs = _fold_instrs(kernel.expr.instrs)
    if subs:
        if kernel.expr.res is not None:
            kernel.expr.res = subs.get(kernel.expr.res, kernel.expr.res)
        if kernel.write is not None:
            if kernel.write.data is not None:
                kernel.write.data = subs.get(
                    kernel.write.data, kernel.write.data
                )
            for dim in kernel.write.dims:
                ir.substitute_regs_linear(dim, subs)


def propagate_constants(program: Program) -> None:
    program.assert_pass("propagate_constants", preserves=ALL_STAGES)
    for target in program.targets.values():
        for kernel in target.kernels:
            simplify_kernel(kernel)
