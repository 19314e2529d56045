"""Affine folding, dead-code elimination and read deduplication.

Parity: reference passes ``foldLinearIndices`` (passes.nim:195-266),
``deadCodeElim`` (passes.nim:268-329), ``deadKernelElim`` (passes.nim:331-350)
and ``deduplicateReads`` (passes.nim:352-381).
"""

from __future__ import annotations

from .. import ir
from ..ir import ALL_STAGES, Instr, Kernel, LinearIndex, Op, Program, Stage


def _fold_setup(index: LinearIndex, kernel: Kernel) -> None:
    """Rewrite ``index`` into canonical affine form over loop iterators.

    Setup instructions that are affine (add/sub/mul-by-const/neg/int literal)
    are folded into ``factors``/``constant``; anything else stays as an opaque
    register backed by its defining instruction.
    """
    regs: dict[int, LinearIndex] = {}
    for loop in kernel.loops:
        regs[loop.iter_reg] = LinearIndex.of_reg(loop.iter_reg)

    def lookup(reg: int) -> LinearIndex:
        return regs.get(reg, LinearIndex.of_reg(reg))

    for instr in index.setup:
        assert instr.res is not None
        if instr.op == Op.IDX:
            regs[instr.res] = LinearIndex.of_const(instr.index_lit)
        elif instr.op == Op.ADD:
            regs[instr.res] = lookup(instr.args[0]) + lookup(instr.args[1])
        elif instr.op == Op.SUB:
            regs[instr.res] = lookup(instr.args[0]) - lookup(instr.args[1])
        elif instr.op == Op.NEG:
            regs[instr.res] = -lookup(instr.args[0])
        elif instr.op == Op.MUL:
            prod = lookup(instr.args[0]).mul(lookup(instr.args[1]))
            regs[instr.res] = (
                prod if prod is not None else LinearIndex.of_reg(instr.res)
            )
        else:
            regs[instr.res] = LinearIndex.of_reg(instr.res)

    total = LinearIndex.of_const(index.constant)
    for reg, factor in index.factors.items():
        total = total + lookup(reg).scaled(factor)

    # keep only setup instructions still referenced by the folded factors
    used = set(total.factors)
    kept: list[Instr] = []
    for instr in reversed(index.setup):
        if instr.res in used:
            kept.append(instr)
            used.update(instr.args)
    kept.reverse()

    index.setup = kept
    index.factors = total.factors
    index.constant = total.constant


def _fold_kernel(kernel: Kernel) -> None:
    for loop in kernel.loops:
        _fold_setup(loop.start, kernel)
        _fold_setup(loop.stop, kernel)
    for read in kernel.reads:
        for dim in read.dims:
            _fold_setup(dim, kernel)
    if kernel.write is not None:
        for dim in kernel.write.dims:
            _fold_setup(dim, kernel)


def fold_linear_indices(program: Program) -> None:
    program.assert_pass(
        "fold_linear_indices",
        produces={Stage.FOLDED},
        preserves=ALL_STAGES,
    )
    for target in program.targets.values():
        for kernel in target.kernels:
            _fold_kernel(kernel)
            if kernel.custom_grad is not None:
                for gk in kernel.custom_grad.kernels:
                    _fold_kernel(gk)


# ---------------------------------------------------------------------------
# dead code elimination
# ---------------------------------------------------------------------------

def _dce_instrs(instrs: list[Instr], used: set[int]) -> list[Instr]:
    kept: list[Instr] = []
    for instr in reversed(instrs):
        if instr.res is not None and instr.res in used:
            kept.append(instr)
            used.update(instr.args)
    kept.reverse()
    return kept


def _dce_linear(index: LinearIndex, used: set[int]) -> None:
    used.update(index.factors)
    index.setup = _dce_instrs(index.setup, used)


def dce_kernel(kernel: Kernel) -> None:
    if kernel.generator.kind != ir.GenKind.NONE:
        return
    used: set[int] = set()
    if kernel.write is not None:
        if kernel.write.data is not None:
            used.add(kernel.write.data)
        for dim in kernel.write.dims:
            _dce_linear(dim, used)
    kernel.expr.instrs = _dce_instrs(kernel.expr.instrs, used)
    # reads may be used by later reads' index expressions (data-dependent
    # indexing), so decide liveness in reverse build order
    kept_rev: list[bool] = []
    for read in reversed(kernel.reads):
        live = read.data in used
        if live:
            for dim in read.dims:
                _dce_linear(dim, used)
        kept_rev.append(live)
    kernel.reads = [
        r for r, live in zip(kernel.reads, reversed(kept_rev)) if live
    ]
    for loop in reversed(kernel.loops):
        _dce_linear(loop.start, used)
        _dce_linear(loop.stop, used)
    kernel.setup = _dce_instrs(kernel.setup, used)


def dead_code_elim(program: Program) -> None:
    program.assert_pass("dead_code_elim", preserves=ALL_STAGES)
    for target in program.targets.values():
        for kernel in target.kernels:
            dce_kernel(kernel)
            if kernel.custom_grad is not None:
                for gk in kernel.custom_grad.kernels:
                    dce_kernel(gk)


def dead_kernel_elim(program: Program) -> None:
    """Drop kernels whose result tensors are never consumed (passes.nim:331)."""
    for target in program.targets.values():
        used: set[int] = set()
        for tid, tensor in enumerate(program.tensors):
            if tensor.kind != ir.TensorKind.RESULT:
                used.add(tid)
        if target.output is not None:
            used.add(target.output)

        kept: list[Kernel] = []
        for kernel in reversed(target.kernels):
            if kernel.generator.kind != ir.GenKind.NONE:
                kept.append(kernel)
                continue
            assert kernel.write is not None
            if kernel.write.tensor in used:
                for tid in kernel.input_tensors():
                    used.add(tid)
                for instr in kernel.expr.instrs:
                    if instr.tensor is not None:
                        used.add(instr.tensor)
                kept.append(kernel)
        kept.reverse()
        target.kernels = kept


# ---------------------------------------------------------------------------
# read deduplication
# ---------------------------------------------------------------------------

def _linear_key(index: LinearIndex):
    return (
        tuple(i.key() for i in index.setup),
        index.factors_key(),
        index.constant,
    )


def _dedup_kernel(kernel: Kernel) -> None:
    unique: dict[tuple, int] = {}
    subs: dict[int, int] = {}
    kept = []
    for read in kernel.reads:
        key = (read.tensor, read.is_raw, tuple(_linear_key(d) for d in read.dims))
        if key in unique:
            assert read.data is not None
            subs[read.data] = unique[key]
        else:
            assert read.data is not None
            unique[key] = read.data
            kept.append(read)
    kernel.reads = kept
    if subs:
        ir.substitute_regs_instrs(kernel.expr.instrs, subs)
        if kernel.expr.res is not None:
            kernel.expr.res = subs.get(kernel.expr.res, kernel.expr.res)
        for read in kernel.reads:  # data-dependent index expressions
            for dim in read.dims:
                ir.substitute_regs_linear(dim, subs)
        if kernel.write is not None:
            for dim in kernel.write.dims:
                ir.substitute_regs_linear(dim, subs)
            if kernel.write.data is not None:
                kernel.write.data = subs.get(kernel.write.data, kernel.write.data)


def deduplicate_reads(program: Program) -> None:
    program.assert_pass("deduplicate_reads", preserves=ALL_STAGES)
    for target in program.targets.values():
        for kernel in target.kernels:
            _dedup_kernel(kernel)
            if kernel.custom_grad is not None:
                for gk in kernel.custom_grad.kernels:
                    _dedup_kernel(gk)


def make_tensor_lookups(program: Program) -> None:
    """Populate program.params / caches / inputs (passes.nim:1760-1772)."""
    program.assert_pass(
        "make_tensor_lookups", produces={Stage.TENSOR_LOOKUPS}, preserves=ALL_STAGES
    )
    program.params = []
    program.caches = []
    for tid, tensor in enumerate(program.tensors):
        if tensor.kind == ir.TensorKind.PARAM:
            program.params.append(tid)
        elif tensor.kind == ir.TensorKind.CACHE:
            program.caches.append(tid)
        elif tensor.kind == ir.TensorKind.INPUT:
            program.inputs[tensor.name] = tid


def collect_tensors(program: Program) -> None:
    """Record every tensor a target touches (passes.nim:936-963)."""
    program.assert_pass(
        "collect_tensors", produces={Stage.COLLECTED}, preserves=ALL_STAGES
    )

    def walk_instrs(instrs: list[Instr], out: set[int]) -> None:
        for instr in instrs:
            if instr.tensor is not None:
                out.add(instr.tensor)

    for target in program.targets.values():
        tensors: set[int] = set()
        for kernel in target.kernels:
            for kind, op in kernel.tensor_ops():
                tensors.add(op.tensor)
                for dim in op.dims:
                    walk_instrs(dim.setup, tensors)
            for loop in kernel.loops:
                walk_instrs(loop.start.setup, tensors)
                walk_instrs(loop.stop.setup, tensors)
            walk_instrs(kernel.setup, tensors)
            walk_instrs(kernel.expr.instrs, tensors)
            if kernel.extern is not None:
                tensors.update(kernel.extern.inputs)
        target.tensors = tensors
