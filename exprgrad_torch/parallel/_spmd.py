"""The sharding pass of the data-parallel executor.

The JAX package traces a target at its global shapes and lets XLA's
SPMD partitioner split it over the mesh.  The port runs the target's
kernels eagerly on each rank, on that rank's rows of the batch, and this
module decides, once per executor, where each tensor lives and which
collectives keep the program's values global.

A tensor's *layout* at a point of the target is one of

* ``REP``         -- replicated: every rank holds all of it;
* ``("S", d)``    -- sharded: each rank holds its chunk of dim ``d``
  over the ``data`` axis, in rank order;
* ``("P", mode)`` -- partial: each rank holds a partial result that the
  ``mode`` reduction ("add", "max", "min") over the ranks completes.

The pass walks the kernels in order.  A kernel whose reads index a
sharded dim with a plain loop iterator (and use that iterator nowhere
else: not in an expression, a condition or another loop's bounds) runs
on the local chunk of that iterator's range.  Every other tensor it
reads is brought to the layout that iterator needs: sliced from a
replicated tensor (no communication), reduce-scattered from a partial
one, or all-gathered.  Its write is sharded when the iterator indexes
the written dim, and partial when the kernel reduces over it -- so a
parameter's gradient, a loss or a statistic over the batch comes out
partial, and the all_reduce that completes it runs after its last
writer and before its first reader.  A kernel that cannot run on a chunk
runs replicated, on gathered inputs.

Two shape tables serve the kernels.  The program's shape queries
(``Op.SHAPE``/``LEN``/``SHAPE_LEN``, the ``1 / n`` of a mean loss, the
``LEN`` setups autodiff emits) and the loop bounds read the global one,
so every constant is the single-device program's; the local one gives
the tensors' allocations, and the sharded loop's extent is the global
one over the ``data`` size.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import ir
from ..backend.executor import TorchExecutor
from ..backend.torcheval import KernelLowering
from ..errors import ModelRuntimeError, ShapeError
from ..interp import accumulation_identity
from ..passes.shapes import resolve_loop_bounds
from . import _comm

REP = ("R",)

# externs whose every input and output is independent along dim 0 (the
# batch; the flash forward's lse [b*h, sq] keeps each row's heads in
# one contiguous block, so its chunks follow the batch's)
_ROW_EXTERNS = ("attention", "attention_grad")


def sharded(dim: int) -> tuple:
    return ("S", dim)


def local_shape(shape, layout, dp: int) -> list[int]:
    shape = list(shape)
    if layout[0] == "S":
        shape[layout[1]] //= dp
    return shape


def _index_regs(index: ir.LinearIndex) -> set:
    regs = set(index.factors)
    for instr in index.setup:
        regs.update(instr.args)
    return regs


@dataclass
class Step:
    """One kernel of the partitioned target: the layout moves before it,
    the loop it runs on a chunk of (``reg``, with ``extent`` local
    iterations; None when it runs replicated), its write's layout, and
    the local shapes of the tensors it touches."""

    moves: list = field(default_factory=list)  # [(tid, src, dst)]
    reg: Optional[int] = None
    extent: int = 0
    out: tuple = REP
    view: dict = field(default_factory=dict)


class Plan:
    """The layouts of one target over ``dp`` data ranks, from the
    layouts of its inputs (``entry``) to those its outputs must leave in
    (``exit``)."""

    def __init__(self, program: ir.Program, target: ir.Target,
                 shapes: dict[int, list[int]], entry: dict[int, tuple],
                 exit_layouts: dict[int, tuple], dp: int) -> None:
        self.program = program
        self.shapes = shapes
        self.dp = dp
        self.state: dict[int, tuple] = dict(entry)
        self.steps: list[Optional[Step]] = []
        for kernel in target.kernels:
            self.steps.append(self._step(kernel))
        self.exit = []
        for tid, lay in sorted(exit_layouts.items()):
            src = self.state.get(tid)
            if src != lay:
                self.exit.append((tid, src, lay))
            self.state[tid] = lay
        del self.state

    # -- counting -----------------------------------------------------
    def collectives(self) -> dict[str, int]:
        """The collectives a run issues, by kind (static)."""
        out: dict[str, int] = {}
        moves = [m for s in self.steps if s is not None for m in s.moves]
        for _, src, dst in moves + self.exit:
            kind = _move_kind(src, dst)
            if kind is not None:
                out[kind] = out.get(kind, 0) + 1
        return out

    def sharded_kernels(self) -> int:
        return sum(1 for s in self.steps
                   if s is not None and (s.reg is not None
                                         or s.out[0] == "S"))

    # -- the walk -----------------------------------------------------
    def _move(self, moves: list, tid: int, dst: tuple) -> None:
        src = self.state.get(tid)
        if src != dst:
            moves.append((tid, src, dst))
        self.state[tid] = dst

    def _view(self, step: Step, tids) -> None:
        for tid in tids:
            lay = self.state.get(tid, REP)
            if lay[0] == "S":
                step.view[tid] = local_shape(self.shapes[tid], lay, self.dp)

    def _step(self, kernel: ir.Kernel) -> Optional[Step]:
        if kernel.write is None:
            return None
        if kernel.extern is not None:
            return self._extern(kernel)
        try:
            starts, sizes, dyn = resolve_loop_bounds(kernel.loops,
                                                     self.shapes)
        except ShapeError as err:
            raise ModelRuntimeError(str(err)) from err
        if not all(s > 0 for s in sizes):
            return None  # an empty kernel: nothing runs, nothing moves
        reg_axis = {loop.iter_reg: a for a, loop in enumerate(kernel.loops)}
        cands = []
        # the iterators indexing a sharded dim of a read, or of the
        # write's current content (the tensor the kernel adds to); a flat
        # (raw) index over a tensor sharded on dim 0 walks its chunk too
        for op in kernel.reads + [kernel.write]:
            lay = self.state.get(op.tensor, REP)
            if lay[0] != "S":
                continue
            if op.is_raw:
                if lay[1] != 0 or len(op.dims) != 1:
                    continue
                index = op.dims[0]
            elif lay[1] < len(op.dims):
                index = op.dims[lay[1]]
            else:
                continue
            reg = index.only_register()
            if reg in reg_axis and not index.setup and reg not in cands:
                cands.append(reg)
        found = None
        for reg in cands:
            found = self._try(kernel, reg, reg_axis, starts, sizes, dyn)
            if found is not None:
                break
        step = Step()
        write = kernel.write
        if found is None:
            for read in kernel.reads:
                self._move(step.moves, read.tensor, REP)
            step.out = REP
            base = REP
        else:
            reg, want, out = found
            step.reg = reg
            step.extent = sizes[reg_axis[reg]] // self.dp
            for tid, lay in want.items():
                self._move(step.moves, tid, lay)
            step.out = out
            base = ("P", write.accumulate) if out[0] == "P" else out
        self._base(step, write.tensor, base)
        self._view(step, [r.tensor for r in kernel.reads] + [write.tensor])
        self.state[write.tensor] = step.out
        return step

    def _base(self, step: Step, tid: int, base: tuple) -> None:
        """Bring the write's current content (what the kernel adds to)
        to ``base``; a tensor nothing has written yet is allocated
        there."""
        if tid not in self.state and self.program.tensors[tid].kind \
                == ir.TensorKind.RESULT:
            step.moves.append((tid, None, base))
            self.state[tid] = base
            return
        self._move(step.moves, tid, base)

    def _try(self, kernel, reg, reg_axis, starts, sizes, dyn):
        """``(reg, {tid: layout} of the reads, write layout)`` when the
        kernel can run on a chunk of ``reg``'s range, else None."""
        axis = reg_axis[reg]
        n = sizes[axis]
        if axis in dyn or starts[axis] != 0 or n % self.dp:
            return None
        for loop in kernel.loops:
            if loop.iter_reg != reg and (
                    reg in _index_regs(loop.start)
                    or reg in _index_regs(loop.stop)):
                return None
        for instr in kernel.setup + kernel.expr.instrs:
            if reg in instr.args:
                return None
        want: dict[int, tuple] = {}

        def layout_of(op):
            uses = [e for e, d in enumerate(op.dims)
                    if reg in _index_regs(d)]
            if not uses:
                return REP
            if len(uses) > 1:
                return None
            e = uses[0]
            d = op.dims[e]
            if d.only_register() != reg or d.setup:
                return None
            shape = self.shapes[op.tensor]
            if op.is_raw:
                # a flat index: its chunks are those of dim 0 (C order)
                if len(op.dims) != 1 or not shape or shape[0] % self.dp \
                        or int(np.prod(shape, dtype=np.int64)) != n:
                    return None
                return sharded(0)
            if shape[e] != n:
                return None
            return sharded(e)

        for read in kernel.reads:
            lay = layout_of(read)
            if lay is None or want.setdefault(read.tensor, lay) != lay:
                return None
        lay = layout_of(kernel.write)
        if lay is None:
            return None
        out = lay if lay[0] == "S" else ("P", kernel.write.accumulate)
        if kernel.write.tensor in want and want[kernel.write.tensor] != out:
            return None
        return reg, want, out

    def _extern(self, kernel: ir.Kernel) -> Step:
        ext = kernel.extern
        out_tid = kernel.write.tensor
        tids = list(ext.inputs) + [out_tid]
        step = Step()
        row = (ext.name in _ROW_EXTERNS
               and any(self.state.get(t) == sharded(0) for t in ext.inputs)
               and all(self.shapes[t] and self.shapes[t][0] % self.dp == 0
                       for t in tids))
        lay = sharded(0) if row else REP
        for tid in ext.inputs:
            self._move(step.moves, tid, lay)
        step.out = lay
        self._base(step, out_tid, lay)
        self._view(step, tids)
        self.state[out_tid] = lay
        return step


def _move_kind(src, dst) -> Optional[str]:
    if src is None or src == dst:
        return None
    if src[0] == "P":
        if dst[0] == "S":
            return "reduce_scatter"
        return "all_reduce"
    if src[0] == "S":
        return "all_gather"
    return None  # a slice, or a partial's base: no communication


class DataParallelExecutor(TorchExecutor):
    """A :class:`TorchExecutor` whose kernels run on this rank's chunk of
    the batch under a :class:`Plan`.  ``run`` takes the inputs at the
    plan's entry layouts and returns the outputs at its exit layouts.
    The matmul-epilogue and row-chain fusion plans are made over the
    local lowerings, from the kernels the plan runs alike
    (:meth:`_joins`): a fused chain's members need no collective between
    them."""

    def __init__(self, program, target_name, shapes, device, plan: Plan,
                 group, schedule_mode: str = "auto") -> None:
        self.plan = plan
        self.group = group
        super().__init__(program, target_name, shapes, device,
                         schedule_mode=schedule_mode)

    def _plan_fusions(self, lowering=None, may_join=None) -> None:
        super()._plan_fusions(lowering=self._lowering, may_join=self._joins)
        # the kernels folded into kernel i: their allocations move to it
        self._folded: dict[int, list[int]] = {}
        index = {id(k): i for i, k in enumerate(self.target.kernels)}
        for i, (_, chain) in self.fused.items():
            self._folded[i] = sorted({index[id(s.kernel)]
                                      for s in chain.steps})
        for i, chain in self.row_fused.items():
            self._folded[i] = list(chain.member_idx[1:])

    def _joins(self, head: int, j: int) -> bool:
        """May kernel ``j`` run fused into the chain kernel ``head``
        starts?  When the plan runs both with nothing moved between
        them: neither leaves a partial result, ``j``'s only move is the
        allocation of its write, and no kernel between them changes the
        layout of a tensor ``j`` reads."""
        steps, kernels = self.plan.steps, self.target.kernels
        if steps[head] is None or steps[j] is None \
                or steps[head].out[0] == "P" or steps[j].out[0] == "P":
            return False
        if j == head:
            return True
        write = kernels[j].write.tensor
        if any(src is not None or tid != write
               for tid, src, _ in steps[j].moves):
            return False
        reads = set(kernels[j].input_tensors()) | {write}
        return not any(src is not None and tid in reads
                       for s in steps[head + 1:j] if s is not None
                       for tid, src, _ in s.moves)

    def _lowering(self, i: int) -> KernelLowering:
        low = self._lowerings.get(i)
        if low is None:
            kernel = self.target.kernels[i]
            step = self.plan.steps[i]
            view = dict(self.shapes)
            extents = {}
            if step is not None:
                view.update(step.view)
                if step.reg is not None:
                    extents[step.reg] = step.extent
            low = KernelLowering(
                self.program, kernel, view, self.dtype, self.device,
                self.policy, None, self._consts, shape_reads=self.shapes,
                extents=extents)
            low.fresh_output = self._fresh_output(kernel)
            self._lowerings[i] = low
        return low

    def _fresh(self, tid: int, layout: tuple) -> torch.Tensor:
        shape = local_shape(self.shapes[tid], layout, self.plan.dp)
        fill = (accumulation_identity(self._extreme[tid])
                if tid in self._extreme else 0.0)
        return torch.full(tuple(shape), fill, dtype=self.dtype,
                          device=self.device)

    def _move(self, tid: int, value, src, dst) -> torch.Tensor:
        group, dp = self.group, self.plan.dp
        me = _comm.rank(group)
        if src is None:
            return self._fresh(tid, dst)
        if src[0] == "P" and src != dst:
            if dst[0] == "S":
                return _comm.reduce_scatter(value, group, dst[1], src[1])
            value = _comm.all_reduce(value, group, src[1])
            src = REP
        if src[0] == "S" and src != dst:
            value = _comm.all_gather(value, group, src[1])
            src = REP
        if dst[0] == "S" and src != dst:
            return _comm.chunk(value, dp, me, dst[1])
        if dst[0] == "P" and src == REP and dst[1] == "add" and me != 0:
            # the replicated content joins the sum once, from rank 0
            return torch.zeros_like(value)
        return value

    def run(self, tensors, shapes, epoch: int, seed: int):
        tensors = dict(tensors)
        for tid, value in self.random_tensors(seed).items():
            tensors.setdefault(tid, value)
        stats = None if self._ran else self.stats
        extern_memo: dict = {}
        for i, _ in enumerate(self.target.kernels):
            step = self.plan.steps[i]
            if step is None or i in self._skip_kernels:
                continue
            # a chain's members allocate their writes with its head
            moves = step.moves + [m for j in self._folded.get(i, ())
                                  for m in self.plan.steps[j].moves]
            for tid, src, dst in moves:
                if tid not in self._fused_away:
                    tensors[tid] = self._move(tid, tensors.get(tid), src,
                                              dst)
            if i in self.fused:
                sm, chain = self.fused[i]
                value = sm.lower_fused(tensors, chain)
                t2 = chain.final_tensor
                tensors[t2] = tensors[t2] + value.reshape(tensors[t2].shape)
                if stats is not None:
                    stats["matmul-fused"] = stats.get("matmul-fused", 0) + 1
                continue
            if i in self.row_fused:
                chain = self.row_fused[i]
                for member in chain.members:
                    member.low.epoch = epoch
                tensors.update(chain.lower(tensors))
                if stats is not None:
                    stats["rowchain"] = stats.get("rowchain", 0) + 1
                continue
            low = self._lowering(i)
            low.extern_memo = extern_memo
            path = low.run(tensors, epoch, stats)
            if stats is not None and path is not None:
                stats[path] = stats.get(path, 0) + 1
        extern_memo.clear()
        for tid, src, dst in self.plan.exit:
            tensors[tid] = self._move(tid, tensors.get(tid), src, dst)
        if stats is not None:
            stats["dp-sharded-kernels"] = self.plan.sharded_kernels()
            for kind, n in self.plan.collectives().items():
                stats[f"dp-{kind}"] = n
        self._ran = True
        return {tid: tensors[tid] for tid in self.output_tids}
