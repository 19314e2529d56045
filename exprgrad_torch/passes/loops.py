"""Loop-bound inference, independence analysis and loop ordering.

Parity: reference ``inferLoopBounds`` (passes.nim:1016-1038),
``identifyIndependent`` (passes.nim:1774-1792) and the locality-scored
``reorderLoops`` heuristic (passes.nim:700-754).
"""

from __future__ import annotations

from .. import ir
from ..ir import (
    ALL_STAGES,
    Instr,
    Kernel,
    LinearIndex,
    LoopMode,
    Op,
    Program,
    Stage,
)


def _use_bounds(loop: ir.Loop, op: ir.TensorOp, dim: int, kernel: Kernel) -> None:
    loop.has_bounds = True
    loop.start = LinearIndex.of_const(0)
    size = kernel.alloc_reg()
    if op.is_raw:
        setup = [Instr(op=Op.LEN, tensor=op.tensor, res=size)]
    else:
        setup = [Instr(op=Op.SHAPE, tensor=op.tensor, dim=dim, res=size)]
    loop.stop = LinearIndex(setup=setup, factors={size: 1})
    loop.step = 1


def infer_loop_bounds(program: Program) -> None:
    """Loops without explicit bounds iterate the extent of the first tensor
    dimension indexed directly by their iterator."""
    program.assert_pass(
        "infer_loop_bounds",
        requires={Stage.FOLDED},
        produces={Stage.BOUNDS},
        preserves=ALL_STAGES,
    )
    for target in program.targets.values():
        for kernel in target.kernels:
            if kernel.generator.kind != ir.GenKind.NONE:
                continue
            unbounded = {
                loop.iter_reg: loop for loop in kernel.loops if not loop.has_bounds
            }
            for kind, op in kernel.tensor_ops():
                for dim, index in enumerate(op.dims):
                    reg = index.only_register()
                    if reg is not None and reg in unbounded:
                        loop = unbounded[reg]
                        if not loop.has_bounds:
                            _use_bounds(loop, op, dim, kernel)


def identify_independent(program: Program) -> None:
    """A loop is independent when its iterator addresses a whole write dim:
    every iteration writes a distinct location."""
    program.assert_pass(
        "identify_independent",
        produces={Stage.INDEPENDENT},
        preserves=ALL_STAGES,
    )
    for target in program.targets.values():
        for kernel in target.kernels:
            if kernel.write is None:
                continue
            independent = set()
            for dim in kernel.write.dims:
                reg = dim.only_register()
                if reg is not None:
                    independent.add(reg)
            for loop in kernel.loops:
                if loop.iter_reg in independent:
                    loop.mode = LoopMode.INDEPENDENT


def reorder_loops(program: Program) -> None:
    """Greedy locality-driven loop ordering (reference passes.nim:700-754).

    Builds edges between loops appearing in adjacent dimensions of the same
    tensor access (reads weighted 10, writes 1) and repeatedly emits the loop
    with the lowest incoming score, so the innermost loops end up indexing
    the fastest-varying (last) dimensions of the tensors being read.
    """
    program.assert_pass("reorder_loops", preserves=ALL_STAGES)
    weights = {"read": 10, "write": 1}
    for target in program.targets.values():
        for kernel in target.kernels:
            n = len(kernel.loops)
            if n <= 1:
                continue
            loop_of_reg = {
                loop.iter_reg: idx for idx, loop in enumerate(kernel.loops)
            }
            edges: list[list[tuple[int, int]]] = [[] for _ in range(n)]
            scores = [0] * n
            for kind, op in kernel.tensor_ops():
                for it in range(1, len(op.dims)):
                    for reg_a in op.dims[it - 1].factors:
                        for reg_b in op.dims[it].factors:
                            if reg_a in loop_of_reg and reg_b in loop_of_reg:
                                w = weights[kind]
                                edges[loop_of_reg[reg_a]].append(
                                    (loop_of_reg[reg_b], w)
                                )
                                scores[loop_of_reg[reg_b]] += w

            closed = [False] * n
            order: list[int] = []
            for _ in range(n):
                best, best_score = -1, 0
                for idx in range(n):
                    if not closed[idx] and (best == -1 or scores[idx] < best_score):
                        best, best_score = idx, scores[idx]
                closed[best] = True
                order.append(best)
                for dst, w in edges[best]:
                    scores[dst] -= w
            kernel.loops = [kernel.loops[idx] for idx in order]
