"""Scheduled map/reduce kernels: classifier and Hopper planner for kernel B5.

Counterpart of the map/reduce part of ``exprgrad_tpu/backend/pallasgen.py``:
the static-evaluation helpers, ``PallasMapReduce``'s classifier (here
:class:`ScheduledMapReduce`, with the same declines and ``why`` strings
where they come from the program) and ``_looks_contraction``.  A kernel

    out[w...] (+= | max= | min=) f(reads)

that carries a schedule and is not a contraction runs one generated
Triton kernel (:mod:`exprgrad_torch.ops.mapreduce`): elementwise ``f``,
in-block and long reductions, shifted/strided/grouped reads, flat
``{i}`` reads and writes, permuted and constant-0 write dims, dynamic
(triangular) bounds, computed-index gathers and scatters, the ``epoch``
operand.

What differs from the TPU emitter is the planner (:meth:`_plan`).  The
TPU blocks every operand into VMEM under a budget, aligns partial blocks
to the (8, 128) tiling and grids at most one reduction axis; none of that
holds on Hopper.  Here every program owns a block of output positions and
loops over the reduced positions inside itself, so any tile the user gave
is only permission to block that axis:

* the VMEM budget, the Mosaic alignment of ragged tiles ("tile size ...
  does not divide extent ... (no mask support)") and the single gridded
  reduction ("more than one tiled reduction axis") do not decline here;
* the one-hot/compare-reduce split of gathers and scatters has no
  counterpart: a gather is a load from a computed address; a scatter
  groups its positions by destination with a stable sort of their keys
  and each program owns a destination's row (:meth:`_plan_segments`);
* the decline of a tile on an axis a shifted read keeps whole (the
  overlapping windows of a stencil) comes from the program and stays.

The classifier is pure analysis on the IR and numpy.  It runs once per
executor and kernel (:data:`classifications` counts it); the generated
kernel is built at the first launch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import ir
from ..ir import Kernel, Op
from ..passes.shapes import eval_linear_interval, trunc_div, trunc_mod

# classifier runs since import; the executor's cache keeps it at one per
# kernel and executor
classifications = 0

# elementwise ops a map/reduce expression may contain (arrays, debug ops
# stay on the plain paths), plus index arithmetic on loop iterators for
# index-dependent masks
_ELEMENTWISE_OPS = {
    Op.SCALAR, Op.BOOL, Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.NEG,
    Op.SIN, Op.COS, Op.EXP, Op.POW, Op.SQRT,
    Op.LOG, Op.LOG10, Op.LOG2, Op.LN,
    Op.EQ, Op.LT, Op.LE, Op.AND, Op.OR, Op.SELECT,
}
_ITER_OPS = {
    Op.IDX, Op.TO_SCALAR, Op.TO_INDEX, Op.IDX_DIV, Op.MOD, Op.WRAP,
}
MAPREDUCE_OPS = _ELEMENTWISE_OPS | _ITER_OPS

NOT_STATIC = object()


def eval_static_instr(instr, env: dict, shapes: dict):
    """Evaluate one instruction to an exact static Python value given an
    env of static values (shape queries and compile-time arithmetic).
    Returns ``NOT_STATIC`` when the op or an argument is not static, or
    when the arithmetic faults (division by zero, domain errors): those
    values take the runtime path, which computes inf/nan as IEEE does."""
    try:
        return _eval_static_instr(instr, env, shapes)
    except (ArithmeticError, ValueError, OverflowError):
        return NOT_STATIC


def _eval_static_instr(instr, env: dict, shapes: dict):
    op = instr.op
    if any(r not in env for r in instr.args):
        return NOT_STATIC
    a = [env[r] for r in instr.args]
    if op == Op.IDX:
        return instr.index_lit
    if op == Op.SCALAR:
        return instr.scalar_lit
    if op == Op.BOOL:
        return instr.bool_lit
    if op in (Op.SHAPE, Op.SHAPE_LEN, Op.LEN):
        shape = shapes.get(instr.tensor)
        if shape is None:
            return NOT_STATIC
        if op == Op.SHAPE:
            return shape[instr.dim]
        if op == Op.SHAPE_LEN:
            return len(shape)
        return int(np.prod(shape, dtype=np.int64))
    if op == Op.ADD:
        return a[0] + a[1]
    if op == Op.SUB:
        return a[0] - a[1]
    if op == Op.MUL:
        return a[0] * a[1]
    if op == Op.NEG:
        return -a[0]
    if op == Op.DIV:
        return a[0] / a[1]
    if op == Op.IDX_DIV:
        return trunc_div(a[0], a[1])
    if op == Op.MOD:
        return trunc_mod(a[0], a[1])
    if op == Op.WRAP:
        return a[0] % a[1] if a[1] > 0 else NOT_STATIC
    if op == Op.TO_SCALAR:
        return float(a[0])
    if op == Op.TO_INDEX:
        return int(a[0])
    if op == Op.SQRT:
        return math.sqrt(a[0])
    if op == Op.EXP:
        return math.exp(a[0])
    if op == Op.LN:
        return math.log(a[0])
    if op == Op.LOG:
        return math.log(a[0]) / math.log(a[1])
    if op == Op.LOG2:
        return math.log2(a[0])
    if op == Op.LOG10:
        return math.log10(a[0])
    if op == Op.POW:
        return a[0] ** a[1]
    if op == Op.SIN:
        return math.sin(a[0])
    if op == Op.COS:
        return math.cos(a[0])
    if op == Op.EQ:
        return a[0] == a[1]
    if op == Op.LT:
        return a[0] < a[1]
    if op == Op.LE:
        return a[0] <= a[1]
    if op == Op.AND:
        return a[0] and a[1]
    if op == Op.OR:
        return a[0] or a[1]
    if op == Op.SELECT:
        return a[1] if a[0] else a[2]
    return NOT_STATIC


def flat_fold(dims: list, shape) -> tuple:
    """Row-major flat fold of a computed-dim group: (V, strides) where
    ``V`` is the flattened extent and ``strides[d]`` the flat stride of
    dim ``d`` (shared by gathers and scatters)."""
    V = 1
    for d in dims:
        V *= int(shape[d])
    strides = {}
    s = 1
    for d in reversed(dims):
        strides[d] = s
        s *= int(shape[d])
    return V, strides


def index_regs(index) -> set:
    """Registers a LinearIndex reads: its factors and its setup's args."""
    regs = set(index.factors)
    for instr in index.setup:
        regs.update(instr.args)
    return regs


class ScheduledMapReduce:
    """Schedule-driven map/reduce kernel (B5) of one IR kernel.

    ``ok`` says whether the kernel runs the generated kernel; ``why``
    carries the decline reason otherwise, as in the JAX package's
    ``PallasMapReduce``.  :meth:`lower` runs it."""

    def __init__(self, lowering, kernel: Kernel):
        global classifications
        classifications += 1
        self.low = lowering
        self.kernel = kernel
        self.why = ""
        self._compiled = None
        self.ok = self._classify()

    def _decline(self, why: str) -> bool:
        self.why = why
        return False

    def _static_setup(self) -> Optional[dict]:
        """Kernel-level setup instructions as exact static values, or None
        when one is not static (the epoch register excepted: it rides as
        a scalar argument of the kernel)."""
        env: dict[int, object] = {}
        for instr in self.kernel.setup:
            v = eval_static_instr(instr, env, self.low.shape_reads)
            if v is NOT_STATIC:
                if instr.op is Op.EPOCH and instr.res is not None:
                    self.epoch_regs.add(instr.res)
                    continue
                return None
            if instr.res is not None:
                env[instr.res] = v
        return env

    def _linear_terms(self, index) -> Optional[tuple]:
        """Split a loop-bound LinearIndex into (const, [(axis, factor)...]):
        iterator factors stay symbolic, everything else must fold to one
        exact static int.  None when it cannot."""
        low = self.low
        terms: list[tuple[int, int]] = []
        rest = ir.LinearIndex(setup=index.setup, constant=index.constant)
        for reg, f in index.factors.items():
            if reg in low.axis_of_reg:
                terms.append((low.axis_of_reg[reg], f))
            else:
                rest.factors[reg] = f
        iv = eval_linear_interval(rest, low.shape_reads, {})
        if iv is None or iv.min != iv.max:
            return None
        return int(iv.min), terms

    def _gather_dim(self, index, plain_info: dict,
                    allow_pure: bool = False) -> Optional[tuple]:
        """Classify a data-dependent index (``emb[to_index(tok[i]), d]``):
        it may reference loop iterators, static setup registers and the
        data registers of plain reads (all dims distinct full-range
        iterators).  Returns ``(sorted axes it varies over, source data
        regs)`` or None.  With ``allow_pure`` the index may be pure
        iterator arithmetic (``a[i * j]``, ``a[(i + j) mod n]``)."""
        low = self.low
        gaxes: set[int] = set()
        srcs: set[int] = set()
        static_env = dict(self.setup_env)
        defined = set(self.setup_env)

        def resolve(reg) -> bool:
            if reg in defined:
                return True
            axis = low.axis_of_reg.get(reg)
            if axis is not None:
                gaxes.add(axis)
                defined.add(reg)
                return True
            if reg in plain_info:
                srcs.add(reg)
                gaxes.update(plain_info[reg])
                defined.add(reg)
                return True
            return False

        for instr in index.setup:
            v = eval_static_instr(instr, static_env, low.shape_reads)
            if v is not NOT_STATIC and instr.res is not None:
                static_env[instr.res] = v
                self.setup_env[instr.res] = v
                defined.add(instr.res)
                continue
            if instr.op not in MAPREDUCE_OPS:
                return None
            if not all(resolve(a) for a in instr.args):
                return None
            if instr.res is not None:
                defined.add(instr.res)
        if not all(resolve(r) for r in index.factors):
            return None
        if not srcs and not allow_pure:
            return None  # pure iterator arithmetic: try affine forms first
        if not gaxes:
            return None  # constant index: stays on the plain paths
        return sorted(gaxes), srcs

    def _affine_dim_plan(self, index, D: int, lane_axis: int):
        """Classify one read dim as an affine/strided/grouped plan:
        ``(axis, plan, whole_axis)``, or the decline reason string when
        the dim is not of the single-iterator affine family (the caller
        then tries the computed-index gather).  The plans keep the JAX
        package's classes so that both accept the same programs; the
        generated kernel evaluates every index as it is written."""
        low = self.low
        deps = low._linear_deps(index)
        if len(deps) != 1:
            return "read index is not a single-iterator form"
        axis = next(iter(deps))
        L = low.sizes[axis]
        vec = low._static_dim_vector(index, axis)
        if vec is None or vec.shape != (L,):
            return "read index is not statically affine"
        c0 = int(vec[0])
        s = int(vec[1] - vec[0]) if L > 1 else 1
        if s >= 1 and np.array_equal(vec, np.arange(L) * s + c0):
            if axis != lane_axis and 0 <= c0 < s and D == s * L:
                return axis, ("stride", s, c0, 0), False
            if c0 + s * (L - 1) < D and (
                axis != lane_axis or s == 1
            ) and (s == 1 or c0 + s * L <= D):
                # shifted stencil (blur: img[y, x + 1]): the read keeps
                # its axis whole, so that axis must not tile
                return axis, ("slice", s, c0, D), True
            return (
                "affine read exceeds the tensor extent or is a "
                "strided lane-axis slice"
            )
        if axis == lane_axis:
            return "transformed read on the lane axis"
        if D >= 1 and L % D == 0 and np.array_equal(
            vec, np.repeat(np.arange(D), L // D)
        ):
            return axis, ("div", L // D, 0, 0), False
        return (
            "read index is neither affine (s*i + c) nor a "
            "grouping (i // k)"
        )

    def _classify(self) -> bool:
        low = self.low
        kernel = self.kernel
        write = kernel.write
        if write is None:
            return self._decline("no write")
        if write.is_raw and len(write.dims) != 1:
            return self._decline("multi-dim raw write")
        self.setup_env: dict[int, object] = {}
        # registers carrying the runtime epoch scalar
        self.epoch_regs: set[int] = set()
        if kernel.setup:
            env = self._static_setup()
            if env is None:
                return self._decline(
                    "kernel-level setup instructions are not static"
                )
            self.setup_env = env
        # dynamic (iterator-dependent) bounds: iterate the static hull and
        # mask points outside the true per-point [start, stop) with the
        # accumulation identity
        self.dyn_bounds: list[tuple] = []  # (axis, lo_terms, hi_terms)
        for a in low.dynamic_axes:
            loop = kernel.loops[a]
            lo = self._linear_terms(loop.start)
            hi = self._linear_terms(loop.stop)
            if lo is None or hi is None:
                return self._decline(
                    "dynamic loop bound is not affine in the iterators"
                )
            self.dyn_bounds.append((a, lo, hi))
        if not low._bounds_ok:
            return self._decline("empty loop range")
        if any(s != 0 for s in low.starts):
            return self._decline("nonzero loop start")
        if low.dtype == torch.float64:
            return self._decline("float64 (VPU computes in f32)")
        if not write.dims:
            return self._decline("scalar output")

        n = low.nloops
        out_shape = low.shapes[write.tensor]
        if write.is_raw:
            out_shape = [int(np.prod(out_shape, dtype=np.int64))]
        self.read_axes: dict[int, list[int]] = {}  # data reg -> axes
        # data reg -> per-dim ("iter"|"stride"|"div"|"slice", param, off, D)
        self.read_plans: dict[int, list[tuple]] = {}
        # data reg -> the order bringing a permuted read into loop order
        self.read_perms: dict[int, tuple] = {}
        # axes a shifted read keeps whole
        self.whole_axes: set[int] = set()
        # data regs read through flat `{i}` access
        self.flat_reads: set[int] = set()
        # data reg -> {"dims", "V", "strides"} for computed-index
        # reads: the computed dims fold into one flat index over their
        # row-major subspace, valid in [0, V)
        self.gather_reads: dict[int, dict] = {}
        # data-dependent write dims (the scatter family)
        self.scatter: Optional[dict] = None
        plain_info: dict[int, list[int]] = {}
        for r in kernel.reads:
            if r.is_raw:
                continue
            shp = low.shapes[r.tensor]
            ax = [low._pure_iter(ix) for ix in r.dims]
            if (
                all(a is not None for a in ax)
                and len(set(ax)) == len(ax)
                and all(
                    low._full_axis(a, shp[i])  # type: ignore[arg-type]
                    for i, a in enumerate(ax)
                )
            ):
                plain_info[r.data] = ax  # type: ignore[assignment]

        out_axes: list[int] = []
        const_dims = 0
        sdims: list[tuple] = []  # (write dim, gaxes, src regs)
        for d, index in enumerate(write.dims):
            axis = low._pure_iter(index)
            if axis is None:
                # constant-0 position into a size-1 dim: the loss family
                if (not index.setup and not index.factors
                        and index.constant == 0 and out_shape[d] == 1):
                    const_dims += 1
                    continue
                g = None
                if not write.is_raw:
                    g = self._gather_dim(index, plain_info)
                    if g is None:
                        g = self._gather_dim(
                            index, plain_info, allow_pure=True
                        )
                if g is not None:
                    sdims.append((d, g[0], g[1]))
                    continue
                return self._decline(
                    "write index is not a full-range iterator")
            if not low._full_axis(axis, out_shape[d]):
                return self._decline(
                    "write index is not a full-range iterator")
            out_axes.append(axis)
        if len(set(out_axes)) != len(out_axes):
            return self._decline("repeated write iterator")
        if sdims:
            if const_dims:
                return self._decline(
                    "constant write dims combined with a data-dependent dim"
                )
            sd = [d for d, _g, _s in sdims]
            V, strides = flat_fold(sd, out_shape)
            self.scatter = {
                "dims": sd,
                "V": V,
                "strides": strides,
                "gaxes": sorted(set().union(*(g for _d, g, _s in sdims))),
            }
        self.write_axes = list(out_axes)
        out_axes = sorted(out_axes)

        lane_axis = n - 1
        for read in kernel.reads:
            shape = low.shapes[read.tensor]
            if read.is_raw:
                if len(read.dims) != 1:
                    return self._decline("multi-dim raw read")
                shape = [int(np.prod(shape, dtype=np.int64))]
                self.flat_reads.add(read.data)
            axes = []
            plans = []
            # per dim: ("iter", axis) | ("affine", axis, plan, whole)
            #        | ("computed", gaxes, src_regs)
            dim_class: list[tuple] = []
            for d, index in enumerate(read.dims):
                axis = low._pure_iter(index)
                if axis is not None and low._full_axis(axis, shape[d]):
                    dim_class.append(("iter", axis))
                    continue
                g = None if read.is_raw else self._gather_dim(
                    index, plain_info
                )
                if g is not None:
                    dim_class.append(("computed",) + g)
                    continue
                got = self._affine_dim_plan(
                    index, int(shape[d]), lane_axis
                )
                if not isinstance(got, str):
                    dim_class.append(("affine",) + got)
                    continue
                if not read.is_raw:
                    g = self._gather_dim(
                        index, plain_info, allow_pure=True
                    )
                    if g is not None:
                        dim_class.append(("computed",) + g)
                        continue
                return self._decline(got)
            gds = [d for d, c in enumerate(dim_class) if c[0] == "computed"]
            if gds:
                # every non-plain dim folds into ONE flat computed index
                for d, c in enumerate(dim_class):
                    if c[0] != "affine":
                        continue
                    g = self._gather_dim(
                        read.dims[d], plain_info, allow_pure=True
                    )
                    if g is None:
                        return self._decline(
                            "strided/grouped dims combined with a "
                            "data-dependent dim"
                        )
                    dim_class[d] = ("computed",) + g
                gds = [
                    d for d, c in enumerate(dim_class) if c[0] == "computed"
                ]
                iter_ds = [
                    d for d, c in enumerate(dim_class) if c[0] == "iter"
                ]
                axes = [dim_class[d][1] for d in iter_ds]
                if len(set(axes)) != len(axes):
                    return self._decline("repeated read iterator")
                V, strides = flat_fold(gds, shape)
                self.gather_reads[read.data] = {
                    "dims": gds,
                    "V": V,
                    "strides": strides,
                }
                axes = sorted(axes)
                plans = [("iter", 1, 0, 0)] * len(axes)
            else:
                for c in dim_class:
                    if c[0] == "iter":
                        axes.append(c[1])
                        plans.append(("iter", 1, 0, 0))
                    else:
                        _, axis, plan, whole = c
                        axes.append(axis)
                        plans.append(plan)
                        if whole:
                            self.whole_axes.add(axis)
                if len(set(axes)) != len(axes):
                    return self._decline("repeated read iterator")
                if axes != sorted(axes):
                    order = sorted(range(len(axes)), key=lambda i: axes[i])
                    self.read_perms[read.data] = tuple(order)
                    axes = [axes[i] for i in order]
                    plans = [plans[i] for i in order]
            self.read_axes[read.data] = axes
            self.read_plans[read.data] = plans

        # expression: elementwise over the read registers; loop iterator
        # references are allowed (index-dependent masks)
        defined = set(self.read_axes) | set(self.setup_env) | self.epoch_regs
        static_env = dict(self.setup_env)
        for instr in kernel.expr.instrs:
            v = eval_static_instr(instr, static_env, low.shape_reads)
            if v is not NOT_STATIC and instr.res is not None:
                static_env[instr.res] = v
                self.setup_env[instr.res] = v
                defined.add(instr.res)
                continue
            if instr.op is Op.EPOCH:
                if instr.res is not None:
                    self.epoch_regs.add(instr.res)
                    defined.add(instr.res)
                continue
            if instr.op not in MAPREDUCE_OPS:
                return self._decline(f"unsupported op {instr.op.value}")
            for arg in instr.args:
                if arg not in defined:
                    if arg not in low.axis_of_reg:
                        return self._decline(
                            "expression uses a register defined outside "
                            "the kernel"
                        )
                    defined.add(arg)
            if instr.res is not None:
                defined.add(instr.res)
        if kernel.expr.res not in defined:
            return self._decline("empty expression")

        self.out_axes = out_axes
        self.red_axes = [a for a in range(n) if a not in out_axes]

        # contraction-shaped kernels (a pure product of >= 2 reads sharing
        # a reduction axis) belong on the einsum/matmul paths, unless the
        # bounds are dynamic or a computed index is involved
        if (write.accumulate == "add" and not self.dyn_bounds
                and not self.gather_reads and self.scatter is None
                and self._looks_contraction()):
            return self._decline("contraction (MXU einsum path)")

        return self._plan()

    def _looks_contraction(self) -> bool:
        defs = {i.res: i for i in self.kernel.expr.instrs}

        def mul_leaves(reg) -> Optional[list[int]]:
            if reg in self.read_axes:
                return [reg]
            instr = defs.get(reg)
            if instr is not None and instr.op == Op.MUL:
                left = mul_leaves(instr.args[0])
                right = mul_leaves(instr.args[1])
                if left is not None and right is not None:
                    return left + right
            return None

        leaves = mul_leaves(self.kernel.expr.res)
        if leaves is None or len(leaves) < 2:
            return False
        red = set(self.red_axes)

        def covers_red_plainly(reg) -> bool:
            return any(
                a in red and plan[0] == "iter"
                for a, plan in zip(self.read_axes[reg],
                                   self.read_plans[reg])
            )

        covering = sum(1 for reg in leaves if covers_red_plainly(reg))
        return covering >= 2

    # ------------------------------------------------------------------
    def value_axes(self) -> set[int]:
        """Loop axes the masked value varies over: the iterators its
        expression, its reads' indices and its bounds masks reference."""
        low = self.low
        kernel = self.kernel
        defs = {}
        for instr in kernel.expr.instrs:
            if instr.res is not None:
                defs[instr.res] = instr
        reads = {r.data: r for r in kernel.reads}
        memo: dict[int, set] = {}

        def index_axes(index) -> set:
            out = set()
            local = {i.res: i for i in index.setup if i.res is not None}
            seen: set = set()

            def visit(reg):
                if reg in seen:
                    return
                seen.add(reg)
                if reg in local:
                    for a in local[reg].args:
                        visit(a)
                else:
                    out.update(axes_of(reg))

            for reg in index_regs(index):
                visit(reg)
            return out

        def axes_of(reg) -> set:
            if reg in memo:
                return memo[reg]
            memo[reg] = set()
            if reg in low.axis_of_reg:
                out = {low.axis_of_reg[reg]}
            elif reg in reads:
                out = set()
                for index in reads[reg].dims:
                    out |= index_axes(index)
            elif reg in defs:
                out = set()
                for a in defs[reg].args:
                    out |= axes_of(a)
            else:
                out = set()  # static setup or the epoch
            memo[reg] = out
            return out

        axes = set(axes_of(kernel.expr.res))
        for a, (_c0, lo), (_c1, hi) in self.dyn_bounds:
            axes.add(a)
            axes.update(dep for dep, _f in lo + hi)
        return axes

    def _plan(self) -> bool:
        """The Hopper plan: program axes P (each program owns a block of
        their positions) and loop axes Q (reduced inside the program).

        A plain write owns its output positions: P is the write's axes, Q
        the reduced axes the value varies over; the others multiply an add
        by their extent.  A scatter's P is every axis the value or its
        target varies over, walked by destination as
        :meth:`_plan_segments` plans it."""
        low = self.low
        kernel = self.kernel
        # a shifted (stencil) read keeps its axis whole: a tile on that
        # axis would cut the overlapping windows
        for axis, loop in enumerate(kernel.loops):
            if (loop.schedule.tile and axis in self.whole_axes
                    and min(loop.schedule.tile_size, low.sizes[axis])
                    < low.sizes[axis]):
                return self._decline(
                    f"loop {axis} carries a shifted-slice read and "
                    f"cannot tile (overlapping windows)"
                )
        vaxes = self.value_axes()
        if self.scatter is not None:
            p = set(self.out_axes) | set(self.scatter["gaxes"])
            p |= vaxes & set(self.red_axes)
            self.p_axes = sorted(p)
            self.q_axes = []
            self._plan_segments()
        else:
            self.p_axes = list(self.out_axes)
            self.q_axes = sorted(vaxes & set(self.red_axes))
        self.phantom = 1
        for a in self.red_axes:
            if a not in self.p_axes and a not in self.q_axes:
                self.phantom *= low.sizes[a]
        self._count_bytes()
        return True

    def _count_bytes(self) -> None:
        """The cost model's inputs (``policy.mapreduce``), counted as the
        JAX package counts them (``pallasgen.py:1782-1800``):
        ``total_bytes``, every read's and the write's whole tensor, and
        ``gather_work``, V candidate values a loop position for each
        computed-index read and for a scatter, over the loop's positions
        as the JAX planner pads them (:meth:`_counted_positions`)."""
        low = self.low
        item = low.dtype.itemsize

        def size(tid):
            return int(np.prod(low.shapes[tid], dtype=np.int64))

        self.total_bytes = (sum(size(r.tensor) for r in self.kernel.reads)
                            + size(self.kernel.write.tensor)) * item
        positions = self._counted_positions()
        work = sum(positions * g["V"] for g in self.gather_reads.values())
        if self.scatter is not None:
            work += positions * self.scatter["V"]
        self.gather_work = work

    def _counted_positions(self) -> int:
        """The loop's positions with each tiled axis padded as the JAX
        planner pads it (``pallasgen.py:1588-1632``: a tile that does not
        divide its extent, or is not a multiple of its aligned block, is
        rounded up to that alignment and the extent to the tile), so both
        packages charge one work measure.  B5 masks instead of padding;
        the calibrated work rates absorb the difference."""
        from math import gcd

        low = self.low
        n = low.nloops
        sub = 16 if low.dtype == torch.bfloat16 else 8

        def align(a):
            return 128 if a == n - 1 else sub if a == n - 2 else 1

        req = {a: align(a) for a in range(n)}
        for data, axes in self.read_axes.items():
            for a, (kind, p, _c, _d) in zip(axes, self.read_plans[data]):
                if kind == "div":
                    need = p * align(a)
                    req[a] = req[a] * need // gcd(req[a], need)

        def round_up(x, m):
            return -(-x // m) * m

        positions = 1
        for axis, loop in enumerate(self.kernel.loops):
            extent = int(low.sizes[axis])
            sched = loop.schedule
            if sched.tile and not sched.share_cache \
                    and axis not in self.whole_axes:
                t = min(sched.tile_size, extent)
                if extent % t or (t != extent and t % req[axis]):
                    t = min(round_up(t, req[axis]),
                            round_up(extent, req[axis]))
                    extent = round_up(extent, t)
            positions *= extent
        return positions

    def _plan_segments(self) -> None:
        """The owner-computes plan of a scatter.  Its positions run over
        the segment axes (those its target or value varies over, but the
        direct write axes the target does not depend on); each position's
        key is its destination row, the row-major flat index over the
        keyed dims (the computed dims and the direct dims whose axis the
        target depends on).  The columns are the other direct axes: every
        program owns one key and a block of columns, walks the key's
        positions and writes its output elements once.  Every size is
        taken: the grouping needs memory for the positions and the rows
        alone."""
        low, sc = self.low, self.scatter
        gaxes = set(sc["gaxes"])
        out_shape = low.shapes[self.kernel.write.tensor]
        keyed, cols = [], []
        for d, index in enumerate(self.kernel.write.dims):
            axis = None if d in sc["dims"] else low._pure_iter(index)
            if axis is None or axis in gaxes:
                keyed.append(d)
            else:
                cols.append(axis)
        K, kstrides = flat_fold(keyed, out_shape)
        sc.update(seg_axes=[a for a in self.p_axes if a not in cols],
                  col_axes=sorted(cols), keyed=keyed, K=K,
                  kstrides=kstrides)

    # ------------------------------------------------------------------
    def compiled(self):
        """The generated kernel (built once)."""
        from ..ops.mapreduce import MapReduceKernel

        if self._compiled is None:
            self._compiled = MapReduceKernel(self)
        return self._compiled

    def plain(self, tensors: dict, epoch: int):
        """The plain version: the port's own lowering of the same kernel
        (its einsum and general paths), on whatever device the tensors
        are."""
        return self.low.run_plain(tensors, epoch)

    def lower(self, tensors: dict):
        from ..ops.mapreduce import mapreduce_impl

        return mapreduce_impl(self.compiled(), tensors, self.low.epoch)
