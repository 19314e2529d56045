"""Compiler pass pipeline.

Parity: the reference pipeline driver lives in model.nim:46-77 (27 passes).
The TPU pipeline is shorter by design: everything after ``reorder_loops`` in
the reference (parallel-loop promotion, tiling, shared-memory caching, loop
inlining, constant propagation, invariant hoisting, closure collection) is
the job of XLA/Mosaic here — kernels are handed to the backend in structured
loop-nest form and lowered to whole-array XLA/Pallas operations.
"""

from __future__ import annotations

from ..ir import Program
from .autodiff import derive_kernel, generate
from .fold import (
    collect_tensors,
    dead_code_elim,
    dead_kernel_elim,
    deduplicate_reads,
    fold_linear_indices,
    make_tensor_lookups,
)
from .loops import identify_independent, infer_loop_bounds, reorder_loops
from .shapes import (
    infer_shape_constraints,
    infer_shapes,
    infer_static_shapes,
    sort_shape_constraints,
)
from .simplify import propagate_constants
from .typecheck import infer_types
from .validate import validate

__all__ = [
    "compile_program",
    "derive_kernel",
    "generate",
    "infer_shapes",
    "infer_types",
    "validate",
]


def compile_program(program: Program) -> None:
    """Run the full pass pipeline in place (reference model.nim:46-77)."""
    make_tensor_lookups(program)
    dead_code_elim(program)
    fold_linear_indices(program)
    deduplicate_reads(program)
    infer_shape_constraints(program)
    generate(program)
    dead_kernel_elim(program)
    fold_linear_indices(program)
    deduplicate_reads(program)
    infer_loop_bounds(program)
    identify_independent(program)
    dead_kernel_elim(program)
    collect_tensors(program)
    sort_shape_constraints(program)
    infer_static_shapes(program)
    infer_types(program)
    reorder_loops(program)
    propagate_constants(program)
    dead_code_elim(program)
    validate(program)
