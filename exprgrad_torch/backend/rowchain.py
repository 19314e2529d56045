"""Row chains: runs of scheduled map/reduce kernels over one loop nest,
fused into one generated Triton kernel (kernel B6).

Counterpart of ``plan_rowchain_fusions``, ``PallasRowChain`` and
``_plan_rowchain_blocks`` of ``exprgrad_tpu/backend/pallasgen.py``.  The
canonical chain is the three-kernel softmax (row max, exp-sum,
normalize); layer_norm and rms_norm are the others.  Per kernel, each
member reads its row again from device memory; fused, a program reads
its rows once, keeps every intermediate (the row max, the sums) in
registers and writes only the final tensor and the intermediates read
outside the chain ("escaping": a training target's gradient kernels read
the forward max and sums).

The grouping rules are the JAX package's: the head is a scheduled
map/reduce kernel writing a RESULT tensor; every member classifies as
:class:`~exprgrad_torch.backend.mapreduce.ScheduledMapReduce` over the
same loop sizes; in-group reads visit the producer's axes in order; every
intermediate has one writer.  The Hopper planner (:func:`plan_blocks`)
replaces the TPU's VMEM budget: a program holds a few whole rows in
registers, padded to a power of two, so it declines

* a member that reduces part of the axes the chain keeps whole (the
  block would need a partial reduction), and
* a row wider than :data:`ROW_LIMIT` elements,

where the JAX package fuses (ROADMAP.md C).
"""

from __future__ import annotations

import numpy as np

from .. import ir
from .scheduled import is_scheduled

# the most elements of one row a program holds in registers (16 warps
# with 64 float32 values a thread)
ROW_LIMIT = 32768
# elements of the block a program aims for
BLOCK_ELEMS = 16384
# programs per H100 (132 SMs) the planner keeps in flight when rows allow
MIN_PROGRAMS = 264


class RowChain:
    """A planned chain: its members, the program's row and column axes
    and its block."""

    def __init__(self, members, member_idx, escaping, p_axes, q_axes,
                 block_p, num_warps):
        self.members = members                  # ScheduledMapReduce each
        self.kernels = [m.kernel for m in members]
        self.member_idx = member_idx
        self.escaping = list(escaping)
        self.final = len(members) - 1
        self.p_axes, self.q_axes = p_axes, q_axes
        self.block_p, self.num_warps = block_p, num_warps
        self._compiled = None
        self._count_bytes()

    def _count_bytes(self) -> None:
        """The cost model's inputs (``policy.rowchain``), counted as the
        JAX package counts them (``pallasgen.py:2362-2372``):
        ``operand_bytes``, each distinct operand the chain reads from
        outside (one per tensor and read pattern), and ``out_bytes``, the
        final tensor and the escaping intermediates."""
        low = self.members[0].low
        item = low.dtype.itemsize

        def size(tid):
            return int(np.prod(low.shapes[tid], dtype=np.int64))

        produced = {k.write.tensor for k in self.kernels[:-1]}
        operands: dict[tuple, int] = {}
        for m in self.members:
            for read in m.kernel.reads:
                if read.tensor in produced:
                    continue
                key = (read.tensor, tuple(m.read_axes[read.data]),
                       tuple(m.read_plans[read.data]),
                       m.read_perms.get(read.data),
                       read.data in m.flat_reads)
                operands.setdefault(key, size(read.tensor))
        self.operand_bytes = sum(operands.values()) * item
        self.out_bytes = sum(
            size(self.kernels[mi].write.tensor)
            for mi in self.out_members) * item

    @property
    def out_members(self) -> list[int]:
        """The members whose tensor the chain writes: final, escaping."""
        return [self.final] + self.escaping

    def compiled(self):
        from ..ops.rowchain import RowChainKernel

        if self._compiled is None:
            self._compiled = RowChainKernel(self)
        return self._compiled

    def plain(self, tensors: dict, epoch: int) -> dict:
        """The plain version: the members one after another through the
        port's own lowering; ``{tid: new value}`` of the final tensor and
        the escaping ones."""
        from ..ops.generated import run_members

        return run_members([m.low for m in self.members],
                           [self.kernels[mi].write.tensor
                            for mi in self.out_members], tensors, epoch)

    def lower(self, tensors: dict) -> dict:
        from ..ops.rowchain import rowchain_impl

        return rowchain_impl(self.compiled(), tensors,
                             self.members[0].low.epoch)


def plan_rowchain_fusions(program, target, lowering_for, policy=None,
                          consumed=frozenset(), may_join=None):
    """Plan row-chain fusions for one target.

    Greedily groups maximal runs of consecutive kernels as the JAX
    package does.  ``lowering_for(i)`` gives kernel ``i``'s (cached)
    KernelLowering.  Returns ``(fused, skipped_kernels, skipped_tensors,
    declines)``: ``fused[i]`` is the RowChain of the head at kernel index
    ``i``, ``declines`` the ``(head index, why)`` of chains the Hopper
    planner refused.  ``consumed`` holds the kernel indices the epilogue
    planner already claimed; ``may_join(head, i)``, where given, says
    whether kernel ``i`` may run fused into the chain kernel ``head``
    starts (``may_join(head, head)``: whether ``head`` may start one)."""
    if policy is not None and not policy.routes_schedules:
        # every chain would be declined at the decision anyway
        return {}, set(), set(), []

    kernels = target.kernels
    reads_of: dict[int, list[int]] = {}
    writes_of: dict[int, list[int]] = {}
    for idx, kernel in enumerate(kernels):
        for tid in kernel.input_tensors():
            reads_of.setdefault(tid, []).append(idx)
        if kernel.write is not None:
            writes_of.setdefault(kernel.write.tensor, []).append(idx)

    def member_for(idx):
        kernel = kernels[idx]
        if kernel.write is None or kernel.write.is_raw or kernel.remat:
            return None
        if kernel.extern:
            return None
        try:
            low = lowering_for(idx)
        except Exception:
            return None
        if not low._bounds_ok or low.dynamic_axes:
            return None
        mr = low.scheduled_mapreduce()
        if not mr.ok or mr.dyn_bounds:
            return None
        if mr.gather_reads:
            return None  # gather members stay single-kernel
        if mr.epoch_regs:
            return None
        if mr.write_axes != mr.out_axes:
            return None
        if len(kernel.write.dims) != len(mr.out_axes):
            return None  # constant-0 dims (the loss family) stay single
        return mr

    fused: dict[int, RowChain] = {}
    skipped_kernels: set[int] = set()
    skipped_tensors: set[int] = set()
    declines: list[tuple[int, str]] = []

    idx = 0
    while idx < len(kernels) - 1:
        kernel = kernels[idx]
        if (idx in consumed or idx in skipped_kernels
                or kernel.write is None or not is_scheduled(kernel)):
            idx += 1
            continue
        t0 = kernel.write.tensor
        if (program.tensors[t0].kind != ir.TensorKind.RESULT
                or t0 == target.output):
            idx += 1
            continue
        head = (member_for(idx) if may_join is None or may_join(idx, idx)
                else None)
        if head is None:
            idx += 1
            continue
        sizes = tuple(head.low.sizes)

        members = [head]
        member_idx = [idx]
        produced = {t0: 0}
        j = idx + 1
        while j < len(kernels):
            if j in consumed:
                break
            nxt = kernels[j]
            if nxt.write is None:
                break
            in_group_reads = [r for r in nxt.reads if r.tensor in produced]
            if not in_group_reads:
                break
            if may_join is not None and not may_join(idx, j):
                break
            m = member_for(j)
            if m is None or tuple(m.low.sizes) != sizes:
                break
            # in-group reads visit the producer's out axes in order
            corresponds = all(
                m.read_axes[r.data] == members[produced[r.tensor]].out_axes
                and all(p[0] == "iter" for p in m.read_plans[r.data])
                and r.data not in m.flat_reads
                and r.data not in m.read_perms
                for r in in_group_reads
            )
            if not corresponds:
                break
            members.append(m)
            member_idx.append(j)
            tw = nxt.write.tensor
            if (program.tensors[tw].kind == ir.TensorKind.RESULT
                    and tw != target.output):
                produced[tw] = len(members) - 1
            else:
                break  # landed on a param/cache/output: the chain ends
            j += 1

        # shrink from the tail until every non-final intermediate has a
        # single writer (its member)
        def group_ok():
            if len(members) < 2:
                return False
            return all(
                writes_of.get(m.kernel.write.tensor) == [pos]
                for m, pos in zip(members[:-1], member_idx[:-1])
            )

        while len(members) >= 2 and not group_ok():
            members.pop()
            member_idx.pop()
        if len(members) < 2:
            idx += 1
            continue

        group = set(member_idx)
        escaping = [
            mi for mi, m in enumerate(members[:-1])
            if not set(reads_of.get(m.kernel.write.tensor, ())) <= group
        ]
        plan = plan_blocks(members, escaping)
        if isinstance(plan, str):
            declines.append((idx, plan))
            idx += 1
            continue
        chain = RowChain(members, member_idx, escaping, *plan)
        if policy is not None and not policy.rowchain(
                chain.operand_bytes, chain.out_bytes,
                len(members)).use_pallas:
            idx += 1  # the members run one by one, each asking mapreduce
            continue
        fused[idx] = chain
        skipped_kernels.update(member_idx[1:])
        esc_set = set(escaping)
        skipped_tensors.update(
            m.kernel.write.tensor
            for mi, m in enumerate(members[:-1])
            if mi not in esc_set
        )
        idx = member_idx[-1] + 1
    return fused, skipped_kernels, skipped_tensors, declines


def plan_blocks(members, escaping):
    """The Hopper block of a chain, ``(p_axes, q_axes, block_p,
    num_warps)``, or the reason it does not fuse.

    Every axis a member reduces, or reads through a transformed index,
    stays whole in the block (the columns Q); the other axes are the rows
    P, a few to a program."""
    low = members[0].low
    n = low.nloops
    sizes = list(low.sizes)

    frozen: set[int] = set()
    for m in members:
        frozen.update(m.red_axes)
        frozen.update(m.whole_axes)
        for data, plans in m.read_plans.items():
            for a, (kind, _p, _c, _D) in zip(m.read_axes[data], plans):
                if kind != "iter":
                    frozen.add(a)
        for axis, loop in enumerate(m.kernel.loops):
            if loop.schedule.share_cache:
                frozen.add(axis)
    p_axes = [a for a in range(n) if a not in frozen]
    q_axes = sorted(frozen)
    if not p_axes:
        return "nothing to grid: every axis is reduced or kept whole"
    for m in members:
        if m.red_axes and set(m.red_axes) != frozen:
            return ("a member reduces part of the axes the chain keeps "
                    "whole (the block holds whole rows)")
    n_q = int(np.prod([sizes[a] for a in q_axes], dtype=np.int64))
    n_p = int(np.prod([sizes[a] for a in p_axes], dtype=np.int64))
    bq = 1 << max(0, n_q - 1).bit_length()
    if bq > ROW_LIMIT:
        return (f"a row of {n_q} elements exceeds the {ROW_LIMIT} a "
                "program holds in registers")
    bp = max(1, BLOCK_ELEMS // bq)
    while bp > 1 and (n_p + bp - 1) // bp < MIN_PROGRAMS:
        bp //= 2
    bp = min(bp, 1 << max(0, n_p - 1).bit_length())
    elems = bp * bq
    warps = 4
    while warps < 16 and elems // (32 * warps) > 16:
        warps *= 2
    return p_axes, q_axes, bp, warps
