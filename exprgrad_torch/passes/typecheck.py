"""Kernel type inference over the 4-type system (Scalar/Index/Boolean/Array).

Parity: reference ``inferTypes`` (passes.nim:20-193); nested loop/GPU opcodes
do not exist here because kernels stay structured.
"""

from __future__ import annotations

from .. import ir
from ..errors import KernelTypeError
from ..ir import (
    ALL_STAGES,
    BOOLEAN_T,
    INDEX_T,
    SCALAR_T,
    Instr,
    Kernel,
    Op,
    Program,
    Stage,
    Type,
    TypeKind,
)


def _infer_instrs(instrs: list[Instr], kernel: Kernel) -> None:
    regs = kernel.regs

    def arg_type(instr: Instr, index: int) -> Type:
        typ = regs[instr.args[index]].typ
        if typ is None:
            raise KernelTypeError(
                f"argument {index} of {instr.op.value} has no inferred type"
            )
        return typ

    for instr in instrs:
        op = instr.op
        if op == Op.IDX:
            ret = INDEX_T
        elif op == Op.SCALAR:
            ret = SCALAR_T
        elif op == Op.BOOL:
            ret = BOOLEAN_T
        elif op in (Op.ADD, Op.SUB, Op.MUL):
            a, b = arg_type(instr, 0), arg_type(instr, 1)
            if a != b:
                raise KernelTypeError(
                    f"arguments of {op.value} must have the same type, got "
                    f"{a} and {b}"
                )
            if a.kind not in (TypeKind.SCALAR, TypeKind.INDEX):
                raise KernelTypeError(
                    f"arguments of {op.value} must be Scalar or Index, got {a}"
                )
            ret = a
        elif op in (Op.EQ, Op.LT, Op.LE):
            a, b = arg_type(instr, 0), arg_type(instr, 1)
            if a != b:
                raise KernelTypeError(
                    f"arguments of {op.value} must have the same type, got "
                    f"{a} and {b}"
                )
            ret = BOOLEAN_T
        elif op == Op.DIV:
            for i in range(2):
                if arg_type(instr, i).kind != TypeKind.SCALAR:
                    raise KernelTypeError(
                        f"arguments of {op.value} must be of type Scalar"
                    )
            ret = SCALAR_T
        elif op in (Op.IDX_DIV, Op.MOD, Op.WRAP):
            for i in range(2):
                if arg_type(instr, i).kind != TypeKind.INDEX:
                    raise KernelTypeError(
                        f"arguments of {op.value} must be of type Index"
                    )
            ret = INDEX_T
        elif op == Op.NEG:
            a = arg_type(instr, 0)
            if a.kind not in (TypeKind.SCALAR, TypeKind.INDEX):
                raise KernelTypeError(
                    f"argument of {op.value} must be Scalar or Index"
                )
            ret = a
        elif op in (Op.AND, Op.OR):
            for i in range(2):
                if arg_type(instr, i).kind != TypeKind.BOOLEAN:
                    raise KernelTypeError(
                        f"arguments of {op.value} must be of type Boolean"
                    )
            ret = BOOLEAN_T
        elif op == Op.SELECT:
            cond, a, b = (arg_type(instr, i) for i in range(3))
            if cond.kind != TypeKind.BOOLEAN:
                raise KernelTypeError("first argument of select must be Boolean")
            if a != b:
                raise KernelTypeError(
                    "the second and third argument of select must have the "
                    "same type"
                )
            ret = a
        elif op == Op.TO_SCALAR:
            if arg_type(instr, 0).kind != TypeKind.INDEX:
                raise KernelTypeError(
                    f"unable to convert {arg_type(instr, 0)} to Scalar"
                )
            ret = SCALAR_T
        elif op == Op.TO_INDEX:
            if arg_type(instr, 0).kind != TypeKind.SCALAR:
                raise KernelTypeError(
                    f"unable to convert {arg_type(instr, 0)} to Index"
                )
            ret = INDEX_T
        elif op in (Op.SIN, Op.COS, Op.EXP, Op.POW, Op.SQRT, Op.LOG,
                    Op.LOG10, Op.LOG2, Op.LN):
            for i in range(len(instr.args)):
                if arg_type(instr, i).kind != TypeKind.SCALAR:
                    raise KernelTypeError(
                        f"argument {i} of {op.value} is of type "
                        f"{arg_type(instr, i)}, but must be of type Scalar"
                    )
            ret = SCALAR_T
        elif op in (Op.SHAPE, Op.LEN, Op.SHAPE_LEN):
            ret = INDEX_T
        elif op == Op.ARRAY:
            first = arg_type(instr, 0)
            for i in range(1, len(instr.args)):
                if arg_type(instr, i) != first:
                    raise KernelTypeError(
                        "all items in an array must have the same type"
                    )
            ret = Type(TypeKind.ARRAY, length=len(instr.args), item=first)
        elif op == Op.ARRAY_LEN:
            if arg_type(instr, 0).kind != TypeKind.ARRAY:
                raise KernelTypeError("argument of array_len must be an array")
            ret = INDEX_T
        elif op == Op.ARRAY_READ:
            arr = arg_type(instr, 0)
            if arr.kind != TypeKind.ARRAY:
                raise KernelTypeError("first argument of array_read must be an array")
            if arg_type(instr, 1).kind != TypeKind.INDEX:
                raise KernelTypeError("second argument of array_read must be an Index")
            assert arr.item is not None
            ret = arr.item
        elif op == Op.EPOCH:
            ret = INDEX_T
        elif op == Op.DEBUG_SCALAR:
            if arg_type(instr, 0).kind != TypeKind.SCALAR:
                raise KernelTypeError(
                    "argument of debug_scalar must be a Scalar"
                )
            ret = SCALAR_T
        elif op == Op.DEBUG_INDEX:
            if arg_type(instr, 0).kind != TypeKind.INDEX:
                raise KernelTypeError("argument of debug_index must be an Index")
            ret = INDEX_T
        else:
            raise KernelTypeError(f"cannot type instruction {op.value}")
        if instr.res is not None:
            regs[instr.res].typ = ret


def infer_types_kernel(kernel: Kernel) -> None:
    if kernel.generator.kind != ir.GenKind.NONE:
        return
    _infer_instrs(kernel.setup, kernel)
    # type iterator registers first: bounds may reference other iterators
    for loop in kernel.loops:
        kernel.regs[loop.iter_reg].typ = INDEX_T
    for loop in kernel.loops:
        _infer_instrs(loop.start.setup, kernel)
        _infer_instrs(loop.stop.setup, kernel)
    for read in kernel.reads:
        for dim in read.dims:
            _infer_instrs(dim.setup, kernel)
            for reg in dim.factors:
                typ = kernel.regs[reg].typ
                if typ is not None and typ.kind != TypeKind.INDEX:
                    raise KernelTypeError("tensor indices must be of type Index")
        assert read.data is not None
        kernel.regs[read.data].typ = SCALAR_T
        if read.is_raw and len(read.dims) != 1:
            raise KernelTypeError("a raw tensor access must have exactly one index")
    _infer_instrs(kernel.expr.instrs, kernel)
    if kernel.write is not None:
        for dim in kernel.write.dims:
            _infer_instrs(dim.setup, kernel)
        if kernel.write.is_raw and len(kernel.write.dims) != 1:
            raise KernelTypeError("a raw tensor access must have exactly one index")
        if kernel.write.data is not None:
            typ = kernel.regs[kernel.write.data].typ
            if typ is not None and typ.kind != TypeKind.SCALAR:
                raise KernelTypeError(
                    "a kernel must write a Scalar to its output tensor"
                )


def infer_types(program: Program) -> None:
    program.assert_pass(
        "infer_types", produces={Stage.TYPED}, preserves=ALL_STAGES
    )
    for target in program.targets.values():
        for kernel in target.kernels:
            try:
                infer_types_kernel(kernel)
            except KernelTypeError as err:
                # attach provenance: which tensor's kernel failed
                if kernel.write is not None:
                    tid = kernel.write.tensor
                    name = program.tensors[tid].name
                    where = f"t{tid}" + (f" ({name!r})" if name else "")
                    raise KernelTypeError(
                        f"in a kernel writing {where} "
                        f"(target {target.name!r}): {err}"
                    ) from None
                raise
