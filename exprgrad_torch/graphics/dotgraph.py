"""Graphviz export of a target's tensor dataflow.

Parity: reference exprgrad/graphics/dotgraph.nim:66-125 — one node per
tensor, one edge per kernel read->write dependency; parameters drawn as
parallelograms, inputs as boxes.
"""

from __future__ import annotations

from .. import ir


_SHAPES = {
    ir.TensorKind.PARAM: "parallelogram",
    ir.TensorKind.INPUT: "box",
    ir.TensorKind.CACHE: "cylinder",
    ir.TensorKind.RANDOM: "diamond",
    ir.TensorKind.RESULT: "ellipse",
}


def to_dot_graph(program: ir.Program, target_name: str) -> str:
    """Render the dataflow of one target as a DOT digraph."""
    target = program.targets[target_name]
    lines = [f'digraph "{target_name}" {{', "  rankdir=TB;"]

    tensors: set[int] = set()
    edges: set[tuple[int, int]] = set()
    for kernel in target.kernels:
        if kernel.write is None:
            continue
        dest = kernel.write.tensor
        tensors.add(dest)
        for read in kernel.reads:
            tensors.add(read.tensor)
            edges.add((read.tensor, dest))

    for tid in sorted(tensors):
        tdef = program.tensors[tid]
        label = tdef.name or f"t{tid}"
        if tdef.shape:
            label += f"\\n{tdef.shape}"
        shape = _SHAPES[tdef.kind]
        style = ' style="bold"' if tid == target.output else ""
        lines.append(f'  t{tid} [label="{label}", shape={shape}{style}];')
    for src, dest in sorted(edges):
        lines.append(f"  t{src} -> t{dest};")
    lines.append("}")
    return "\n".join(lines)
