"""Lowering of structured kernels to PyTorch tensor operations.

Counterpart of ``exprgrad_tpu/backend/jaxeval.py``.  A kernel is a loop
nest with an expression accumulated into a write location; instead of
scalar loops each kernel becomes whole-tensor operations chosen by
pattern:

* **contraction** — the expression is a product of tensor reads and every
  access index is a plain loop iterator: ``torch.einsum``.  This covers
  matmul/dense forward and the derived backward kernels.  A product of
  two float32 operands on a CUDA device under precision "highest" (TF32
  off) that maps onto one GEMM runs instead on B1's Hopper mainloop
  (:func:`~exprgrad_torch.ops.matmul.contract`, stat ``einsum-b1``)
  where ``policy.contraction`` says so.
* **convolution** — a product of two reads whose indices are affine sums
  of loop iterators (a conv's forward, filter gradient or image
  gradient): one ``torch.nn.functional.conv1d/2d/3d``
  (:mod:`~exprgrad_torch.backend.convmatch`, stat ``conv``).  A match
  over more than 3 spatial dims declines with a ``ScheduleWarning`` and
  a ``schedule-fallback`` stat naming the reason.
* **direct reads/writes** — accesses whose indices are distinct
  full-range iterators become permutes/reshapes; reduction axes become
  ``sum``/``amax``/``amin``.
* **structured writes** — affine ``s*i + c`` and grouped ``i // k`` write
  indices become (strided) slice updates and reshape-reductions.
* **general** — arbitrary affine/computed indices use a gather over the
  broadcast loop grid and a scatter (``index_put_(accumulate=True)`` for
  ``+=``, ``scatter_reduce_`` for max/min).

PyTorch runs eagerly, so each kernel executes as soon as it is lowered.
Tensors are never updated in place: a write returns a new tensor, as in
the JAX package, so the model's parameters stay intact until the run
that updates them has finished.

Scheduled kernels (``Fun.schedule``) are routed first, in the order of
``jaxeval.py``, under the policy of :mod:`~exprgrad_torch.backend.policy`:
a contraction the classifier of :mod:`~exprgrad_torch.backend.scheduled`
accepts runs kernel B1 (stat ``matmul``) where ``policy.contraction``
says so; any other kernel the classifier of
:mod:`~exprgrad_torch.backend.mapreduce` accepts runs a generated
map/reduce kernel, B5 (stat ``mapreduce``), where ``policy.mapreduce``
says so.  A kernel the cost model routes away, or both classifiers
decline, lowers through the paths above with a ``ScheduleWarning`` and a
``schedule-fallback`` stat; a matmul-shaped kernel that B1 declined late
reports B1's reason.  Runs of map/reduce kernels that fuse into one row
chain (B6) never reach this module: the executor runs them.

The executor keeps one lowering per kernel, so the classification of a
scheduled kernel and its generated kernel are made once per executor.
"""

from __future__ import annotations

import math
import string
from typing import Optional

import numpy as np
import torch

from .. import ir
from ..errors import ModelRuntimeError, ShapeError
from ..interp import accumulation_identity
from ..ir import Kernel, LinearIndex, Op, Program
from ..ops import matmul as ops_matmul
from ..passes.shapes import resolve_loop_bounds

from ..registry import ExternContext, get_extern
from .convmatch import ConvMatch
from .mapreduce import ScheduledMapReduce
from .policy import SchedulePolicy
from .scheduled import ScheduledMatmul, is_scheduled


def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _int_trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _as_tensor(x, like):
    """``x`` as a tensor; a Python number becomes a 0-d tensor on the
    device of ``like`` (the other, tensor operand)."""
    return x if _is_t(x) else torch.full((), x, device=like.device)


def _trunc_div(a, b):
    """Nim-style truncated division (rounds toward zero)."""
    if not _is_t(a) and not _is_t(b):
        return _int_trunc_div(a, b)
    return torch.div(_as_tensor(a, b), b, rounding_mode="trunc")


def _trunc_mod(a, b):
    """Remainder of truncated division (takes the dividend's sign)."""
    if not _is_t(a) and not _is_t(b):
        return a - _int_trunc_div(a, b) * b
    return torch.fmod(_as_tensor(a, b), b)


def _wrap(a, b):
    """Floored modulo (the DSL's ``wrap``)."""
    if not _is_t(a) and not _is_t(b):
        return a % b
    return torch.remainder(_as_tensor(a, b), b)


class _ArrayVal:
    __slots__ = ("data", "array_ndim")

    def __init__(self, data, array_ndim: int) -> None:
        self.data = data
        self.array_ndim = array_ndim


def _acc_reduce(vals, axis: int, mode: str, keepdims: bool = True):
    if mode == "add":
        return vals.sum(dim=axis, keepdim=keepdims)
    if mode == "max":
        return vals.amax(dim=axis, keepdim=keepdims)
    return vals.amin(dim=axis, keepdim=keepdims)


def _acc_combine(out, vals, mode: str):
    if mode == "add":
        return out + vals
    if mode == "max":
        return torch.maximum(out, vals)
    return torch.minimum(out, vals)


def _wrap_clamp(flat, total: int):
    """Normalize negative indices (Python-style) and clamp into range, as
    JAX's gathers do; out-of-range reads never reach the device."""
    if not _is_t(flat):
        flat = flat + total if flat < 0 else flat
        return min(max(flat, 0), total - 1)
    flat = torch.where(flat < 0, flat + total, flat)
    return flat.clamp(0, total - 1)


_UNARY = {
    Op.SIN: torch.sin, Op.COS: torch.cos, Op.EXP: torch.exp,
    Op.SQRT: torch.sqrt, Op.LN: torch.log, Op.LOG2: torch.log2,
    Op.LOG10: torch.log10,
}


class KernelLowering:
    """Lower and run one kernel at concrete shapes.

    ``consts`` caches 0-d device tensors of scalar literals across the runs
    of one executor, so a literal costs no host-to-device copy after the
    first run."""

    def __init__(
        self,
        program: Program,
        kernel: Kernel,
        shapes: dict[int, list[int]],
        dtype: torch.dtype,
        device: torch.device,
        policy: Optional[SchedulePolicy] = None,
        extern_memo: Optional[dict] = None,
        consts: Optional[dict] = None,
        shape_reads: Optional[dict[int, list[int]]] = None,
        extents: Optional[dict[int, int]] = None,
    ) -> None:
        self.program = program
        self.kernel = kernel
        self.shapes = shapes
        # A data-parallel executor runs the kernel on a shard: ``shapes``
        # then holds the local shapes (allocations, the tensors as they
        # are), ``shape_reads`` the global ones that the program's shape
        # queries and loop bounds read, and ``extents`` the local size of
        # the sharded loop (by iterator register).
        self.shape_reads = shape_reads if shape_reads is not None else shapes
        self.extents = extents or {}
        self.dtype = dtype
        self.device = device
        self.policy = policy if policy is not None else SchedulePolicy()
        self.extern_memo = extern_memo if extern_memo is not None else {}
        self.consts = consts if consts is not None else {}
        self.nloops = len(kernel.loops)
        self.starts: list[int] = []
        self.sizes: list[int] = []
        self.axis_of_reg: dict[int, int] = {}
        self.env: dict[int, object] = {}
        self.dynamic_axes: list[int] = []
        self.epoch = 0
        self._bounds_ok = self._eval_bounds()
        # set by the executor: the output is a RESULT tensor this kernel
        # alone writes, so it holds the identity when the kernel runs
        self.fresh_output = False
        self._matmul: Optional[ScheduledMatmul] = None
        self._mapreduce: Optional[ScheduledMapReduce] = None
        self._conv: Optional[ConvMatch] = None
        self._decision: Optional[tuple] = None  # scheduled_decision()
        self._parsed = None  # _einsum(), False: not a contraction
        self._gemm = None  # einsum_gemm(), False: torch.einsum

    # ------------------------------------------------------------------
    def _const(self, value):
        """0-d device tensor of the program dtype holding ``value``."""
        key = float(value)
        tensor = self.consts.get(key)
        if tensor is None:
            tensor = torch.full((), key, dtype=self.dtype, device=self.device)
            self.consts[key] = tensor
        return tensor

    def _scalar(self, value):
        """``value`` as a tensor of the program dtype."""
        if _is_t(value):
            return value.to(self.dtype)
        return self._const(value)

    def _eval_bounds(self) -> bool:
        for loop in self.kernel.loops:
            if not loop.has_bounds:
                raise ModelRuntimeError(
                    "loop range could not be inferred; use a bounded iterator"
                )
        try:
            self.starts, self.sizes, self.dynamic_axes = resolve_loop_bounds(
                self.kernel.loops, self.shape_reads
            )
        except ShapeError as err:
            raise ModelRuntimeError(str(err)) from err
        for axis, loop in enumerate(self.kernel.loops):
            self.axis_of_reg[loop.iter_reg] = axis
            if loop.iter_reg in self.extents:
                self.sizes[axis] = self.extents[loop.iter_reg]
        return all(s > 0 for s in self.sizes)

    def _pure_iter(self, index: LinearIndex) -> Optional[int]:
        """Loop axis when index == one plain iterator."""
        reg = index.only_register()
        if reg is not None and reg in self.axis_of_reg and not index.setup:
            return self.axis_of_reg[reg]
        return None

    def _full_axis(self, axis: int, size: int) -> bool:
        return self.starts[axis] == 0 and self.sizes[axis] == size

    def _arange(self, axis: int):
        return torch.arange(
            self.starts[axis], self.starts[axis] + self.sizes[axis],
            device=self.device,
        )

    # ------------------------------------------------------------------
    # fast path: contraction -> einsum, or B1's Hopper mainloop
    # ------------------------------------------------------------------
    def _einsum(self):
        """The kernel as an einsum, parsed once: ``(factors, out_axes,
        const)`` with ``factors`` the ``(tensor, axes)`` of each read of
        the product and ``const`` its scalar literals' product; None where
        the kernel is not a product of plain full-range reads."""
        if self._parsed is None:
            self._parsed = self._parse_einsum() or False
        return self._parsed or None

    def _parse_einsum(self):
        kernel = self.kernel
        write = kernel.write
        assert write is not None
        if write.is_raw or kernel.setup:
            return None
        out_shape = self.shapes[write.tensor]
        out_axes: list[int] = []
        for dim, index in enumerate(write.dims):
            axis = self._pure_iter(index)
            if axis is None or not self._full_axis(axis, out_shape[dim]):
                return None
            out_axes.append(axis)
        if len(set(out_axes)) != len(out_axes):
            return None
        reads_by_reg = {}
        for read in kernel.reads:
            if read.is_raw:
                return None
            shape = self.shapes[read.tensor]
            axes = []
            for dim, index in enumerate(read.dims):
                axis = self._pure_iter(index)
                if axis is None or not self._full_axis(axis, shape[dim]):
                    return None
                axes.append(axis)
            if len(set(axes)) != len(axes):
                return None
            reads_by_reg[read.data] = (read.tensor, tuple(axes))

        # the expression must be a product of reads and scalar literals
        defs = {i.res: i for i in kernel.expr.instrs}
        memo: dict = {}

        def walk(reg):
            if reg not in memo:
                memo[reg] = _walk(reg)
            return memo[reg]

        def _walk(reg):
            if reg in reads_by_reg:
                return [reg], 1.0
            instr = defs.get(reg)
            if instr is None:
                return None
            if instr.op == Op.MUL:
                left = walk(instr.args[0])
                right = walk(instr.args[1])
                if left and right:
                    return left[0] + right[0], left[1] * right[1]
            elif instr.op == Op.SCALAR:
                return [], instr.scalar_lit
            elif instr.op == Op.NEG:
                inner = walk(instr.args[0])
                if inner:
                    return inner[0], -inner[1]
            elif instr.op == Op.DIV:
                left = walk(instr.args[0])
                right = walk(instr.args[1])
                if left and right and not right[0]:
                    return left[0], left[1] / right[1]
            return None

        assert kernel.expr.res is not None
        parsed = walk(kernel.expr.res)
        if parsed is None or not parsed[0]:
            return None
        factor_regs, const = parsed
        return [reads_by_reg[reg] for reg in factor_regs], out_axes, const

    def einsum_gemm(self):
        """``(plan, alpha)`` where this kernel's einsum runs on B1's Hopper
        mainloop (:func:`~exprgrad_torch.ops.matmul.contract`), decided
        once; else None.  It does where the program is float32 on a CUDA
        device, the einsum is one GEMM the kernel takes
        (:func:`~exprgrad_torch.ops.matmul.plan_gemm`: two operands, a
        summed axis, no broadcast axis) and the cost model
        (:meth:`SchedulePolicy.einsum_contraction`) says the kernel wins
        at its m, n and k.  The run also asks for TF32 off (precision
        "highest"): other precisions keep torch.einsum."""
        if self._gemm is None:
            self._gemm = self._plan_gemm() or False
        return self._gemm or None

    def _plan_gemm(self):
        parsed = self._einsum()
        if (parsed is None or self.device.type != "cuda"
                or self.dtype != torch.float32):
            return None
        factors, out_axes, const = parsed
        plan, _ = ops_matmul.plan_gemm([axes for _, axes in factors],
                                       out_axes, self.sizes)
        if plan is None:
            return None
        covered = {a for _, axes in factors for a in axes}
        alpha = const
        for axis in range(self.nloops):
            if axis not in covered and axis not in out_axes:
                alpha *= self.sizes[axis]  # a phantom axis' trip count
        a_shape = self.shapes[factors[1 if plan.swap else 0][0]]
        b_shape = self.shapes[factors[0 if plan.swap else 1][0]]
        batch, m, k = (math.prod(a_shape[d] for d in g) for g in plan.a)
        n = math.prod(b_shape[d] for d in plan.b[1])
        if not self.policy.einsum_contraction(batch * m, n, k).use_pallas:
            return None
        return plan, alpha

    def contraction_decision(self, sm, policy=None, epilogue: int = 0):
        """``policy.contraction`` (this lowering's policy where None) for
        this kernel as the scheduled matmul ``sm`` with ``epilogue``
        kernels folded into it, its plain side priced as the plain
        lowering runs it: on B1's Hopper mainloop where
        :meth:`einsum_gemm` takes the kernel."""
        policy = policy if policy is not None else self.policy
        return policy.contraction(sm.m, sm.n, sm.k, self.dtype,
                                  plain_gemm=self.einsum_gemm() is not None,
                                  epilogue=epilogue)

    def _try_contraction(self, tensors: dict, route: bool = True):
        """``(new value of the output, path)`` by the einsum fast path, or
        None where the kernel is not a contraction: ``"einsum-b1"`` where
        B1's Hopper mainloop ran it (``route`` and :meth:`einsum_gemm`),
        else ``"einsum"`` (torch.einsum)."""
        parsed = self._einsum()
        if parsed is None:
            return None
        factors, out_axes, const = parsed
        write = self.kernel.write
        gemm = self.einsum_gemm() if route else None
        if gemm is not None and not torch.backends.cuda.matmul.allow_tf32:
            plan, alpha = gemm
            (ta, _), (tb, _) = factors
            c = None if self.fresh_output else tensors[write.tensor]
            return ops_matmul.contract(tensors[ta], tensors[tb], plan,
                                       self.shapes[write.tensor], alpha,
                                       c), "einsum-b1"

        letters = string.ascii_letters
        covered: set[int] = set()
        in_specs = []
        operands = []
        for tensor, axes in factors:
            in_specs.append("".join(letters[a] for a in axes))
            operands.append(tensors[tensor])
            covered.update(axes)
        out_spec = "".join(letters[a] for a in out_axes if a in covered)
        value = torch.einsum(",".join(in_specs) + "->" + out_spec, *operands)
        if const != 1.0:
            value = value * const
        # phantom axes: in neither reads nor write -> multiply by trip count
        for axis in range(self.nloops):
            if axis not in covered and axis not in out_axes:
                value = value * self.sizes[axis]
        # broadcast axes: in the write but in no read
        if any(a not in covered for a in out_axes):
            shape = [self.sizes[a] if a in covered else 1 for a in out_axes]
            value = value.reshape(shape).expand(
                [self.sizes[a] for a in out_axes]
            )
        return tensors[write.tensor] + value.to(self.dtype), "einsum"

    # ------------------------------------------------------------------
    # general vectorized path
    # ------------------------------------------------------------------
    def _grid_slot(self, axis: int):
        shape = [1] * self.nloops
        shape[axis] = self.sizes[axis]
        return self._arange(axis).reshape(shape)

    def eval_instrs(self, instrs, tensors) -> None:
        env = self.env
        for instr in instrs:
            op = instr.op
            a = [env[x] for x in instr.args]
            if op == Op.IDX:
                value = instr.index_lit
            elif op == Op.SCALAR:
                value = self._const(instr.scalar_lit)
            elif op == Op.BOOL:
                value = instr.bool_lit
            elif op == Op.ADD:
                value = a[0] + a[1]
            elif op == Op.SUB:
                value = a[0] - a[1]
            elif op == Op.MUL:
                value = a[0] * a[1]
            elif op == Op.DIV:
                value = a[0] / a[1]
            elif op == Op.IDX_DIV:
                value = _trunc_div(a[0], a[1])
            elif op == Op.MOD:
                value = _trunc_mod(a[0], a[1])
            elif op == Op.WRAP:
                value = _wrap(a[0], a[1])
            elif op == Op.NEG:
                if isinstance(a[0], bool):
                    value = not a[0]
                elif _is_t(a[0]) and a[0].dtype == torch.bool:
                    value = ~a[0]
                else:
                    value = -a[0]
            elif op in _UNARY:
                value = _UNARY[op](a[0])
            elif op == Op.POW:
                value = torch.pow(a[0], a[1])
            elif op == Op.LOG:
                value = torch.log(a[0]) / torch.log(a[1])
            elif op == Op.EQ:
                value = a[0] == a[1]
            elif op == Op.LT:
                value = a[0] < a[1]
            elif op == Op.LE:
                value = a[0] <= a[1]
            elif op in (Op.AND, Op.OR):
                if not _is_t(a[0]) and not _is_t(a[1]):
                    value = (a[0] and a[1]) if op == Op.AND else (
                        a[0] or a[1])
                else:
                    fn = (torch.logical_and if op == Op.AND
                          else torch.logical_or)
                    value = fn(self._bool(a[0]), self._bool(a[1]))
            elif op == Op.SELECT:
                if _is_t(a[0]):
                    value = torch.where(a[0], a[1], a[2])
                else:
                    value = a[1] if a[0] else a[2]
            elif op == Op.TO_SCALAR:
                value = self._scalar(a[0])
            elif op == Op.TO_INDEX:
                value = torch.trunc(a[0]).to(torch.int64)
            elif op == Op.SHAPE:
                value = self.shape_reads[instr.tensor][instr.dim]
            elif op == Op.LEN:
                value = int(np.prod(self.shape_reads[instr.tensor],
                                    dtype=np.int64))
            elif op == Op.SHAPE_LEN:
                value = len(self.shape_reads[instr.tensor])
            elif op == Op.EPOCH:
                value = self.epoch
            elif op in (Op.DEBUG_SCALAR, Op.DEBUG_INDEX):
                print(f"{instr.label}: {a[0]}", flush=True)
                value = a[0]
            elif op == Op.ARRAY:
                value = self._make_array(a)
            elif op == Op.ARRAY_LEN:
                av = a[0]
                value = av.data.shape[av.data.dim() - av.array_ndim]
            elif op == Op.ARRAY_READ:
                value = self._array_read(a[0], a[1])
            else:
                raise ModelRuntimeError(f"cannot lower {op.value}")
            if instr.res is not None:
                env[instr.res] = value

    def _bool(self, x):
        if _is_t(x):
            return x
        return torch.full((), bool(x), device=self.device)

    def _make_array(self, items):
        if items and isinstance(items[0], _ArrayVal):
            inner = items[0].array_ndim
            data = torch.stack([it.data for it in items], dim=-inner - 1)
            return _ArrayVal(data, inner + 1)
        values = torch.broadcast_tensors(*(self._scalar(v) for v in items))
        return _ArrayVal(torch.stack(values, dim=-1), 1)

    def _array_read(self, av, idx):
        axis = av.data.dim() - av.array_ndim
        if not _is_t(idx):
            data = av.data.select(axis, int(idx))
            if av.array_ndim == 1:
                return data
            return _ArrayVal(data, av.array_ndim - 1)
        grid_shape = torch.broadcast_shapes(av.data.shape[:axis], idx.shape)
        data = av.data.expand(tuple(grid_shape) + tuple(av.data.shape[axis:]))
        axis = data.dim() - av.array_ndim
        idx_e = idx.reshape(tuple(idx.shape) + (1,) * av.array_ndim).expand(
            tuple(grid_shape) + (1,) + tuple(data.shape[axis + 1:])
        )
        taken = torch.take_along_dim(data, idx_e, dim=axis).squeeze(axis)
        if av.array_ndim == 1:
            return taken
        return _ArrayVal(taken, av.array_ndim - 1)

    def _eval_linear_vec(self, index: LinearIndex, tensors):
        self.eval_instrs(index.setup, tensors)
        value = index.constant
        for reg, factor in index.factors.items():
            value = value + self.env[reg] * factor
        return value

    def _linear_deps(self, index: LinearIndex) -> set[int]:
        """Loop axes a linear index expression depends on."""
        regs = set(index.factors)
        for instr in index.setup:
            regs.update(instr.args)
        return {self.axis_of_reg[r] for r in regs if r in self.axis_of_reg}

    def _dim_index_1d(self, index: LinearIndex, axis: Optional[int]):
        """Evaluate one dim's index with its loop iterator as a 1-D vector.

        Returns a Python int for loop-independent dims, else an int64
        vector of the loop's length; None when the index depends on a
        value outside the loop grid (a data-dependent read)."""
        saved_env = self.env
        self.env = {}
        try:
            if axis is not None:
                self.env[self.kernel.loops[axis].iter_reg] = self._arange(axis)
            value = self._eval_linear_vec(index, None)
        except KeyError:
            return None
        finally:
            self.env = saved_env
        return value

    def _static_dim_vector(self, index: LinearIndex, axis: int):
        """Statically evaluate one dim's index as a numpy int vector over its
        loop axis; None when the index depends on runtime values."""
        env: dict[int, np.ndarray | int] = {
            self.kernel.loops[axis].iter_reg: np.arange(
                self.starts[axis], self.starts[axis] + self.sizes[axis]
            )
        }
        for instr in index.setup:
            if any(a not in env for a in instr.args):
                return None
            a = [env[x] for x in instr.args]
            op = instr.op
            if op == Op.IDX:
                value = instr.index_lit
            elif op == Op.ADD:
                value = a[0] + a[1]
            elif op == Op.SUB:
                value = a[0] - a[1]
            elif op == Op.MUL:
                value = a[0] * a[1]
            elif op in (Op.IDX_DIV, Op.MOD):
                q = np.floor_divide(a[0], a[1])
                r = a[0] - q * a[1]
                q = q + (
                    (r != 0)
                    & ((np.asarray(a[0]) < 0) != (np.asarray(a[1]) < 0))
                )
                value = q if op == Op.IDX_DIV else a[0] - q * a[1]
            elif op == Op.WRAP:
                value = np.mod(a[0], a[1])
            elif op == Op.NEG:
                value = -a[0]
            elif op == Op.SHAPE:
                value = self.shape_reads[instr.tensor][instr.dim]
            elif op == Op.LEN:
                value = int(np.prod(self.shape_reads[instr.tensor],
                                    dtype=np.int64))
            elif op == Op.SHAPE_LEN:
                value = len(self.shape_reads[instr.tensor])
            else:
                return None  # epoch / reads / non-index ops: not static
            if instr.res is not None:
                env[instr.res] = value
        try:
            value = index.constant
            for reg, factor in index.factors.items():
                value = value + env[reg] * factor
        except KeyError:
            return None
        value = np.asarray(value)
        if value.ndim == 0:
            value = np.broadcast_to(value, (self.sizes[axis],))
        return value.astype(np.int64)

    def _read_value(self, read: ir.TensorOp, tensors):
        """Lower a tensor read.  Strategies, fastest first:

        1. plain full-range iterators -> permute/reshape (a view)
        2. separable indices (each dim depends on <=1 distinct loop axis) ->
           per-axis strided slice / repeat / ``index_select``
        3. general flat gather over the broadcast loop grid
        """
        tensor = tensors[read.tensor]
        shape = self.shapes[read.tensor]
        if not read.is_raw:
            axes = [self._pure_iter(d) for d in read.dims]
            if (
                all(a is not None for a in axes)
                and len(set(axes)) == len(axes)
                and all(
                    self._full_axis(a, shape[d])  # type: ignore[arg-type]
                    for d, a in enumerate(axes)
                )
            ):
                perm = sorted(range(len(axes)), key=lambda d: axes[d])
                out_shape = [1] * self.nloops
                for d, a in enumerate(axes):
                    out_shape[a] = shape[d]
                return tensor.permute(perm).reshape(out_shape)

            sep = self._try_separable_read(read, tensor, shape)
            if sep is not None:
                return sep
        else:
            axis = self._pure_iter(read.dims[0])
            total = int(np.prod(shape, dtype=np.int64))
            if axis is not None and self._full_axis(axis, total):
                out_shape = [1] * self.nloops
                out_shape[axis] = total
                return tensor.reshape(out_shape)
        flat = self._flat_index(read, tensors)
        total = int(np.prod(shape, dtype=np.int64))
        # hull points of dynamic loops may index out of range; their
        # contribution is masked to the identity
        return tensor.reshape(-1)[_wrap_clamp(flat, total)]

    def _try_separable_read(self, read: ir.TensorOp, tensor, shape):
        deps = [self._linear_deps(d) for d in read.dims]
        if any(len(d) > 1 for d in deps):
            return None
        dep_axes = [next(iter(d)) if d else None for d in deps]
        non_none = [a for a in dep_axes if a is not None]
        if len(set(non_none)) != len(non_none):
            return None

        value = tensor
        for d, (index, axis) in enumerate(zip(read.dims, dep_axes)):
            if axis is None:
                idx = self._dim_index_1d(index, None)
                if _is_t(idx) or idx is None:
                    return None
                value = value.narrow(d, int(idx), 1)
                continue
            # affine in the iterator -> strided slice
            if not index.setup:
                stride = index.factors.get(self.kernel.loops[axis].iter_reg, 0)
                offset = index.constant + stride * self.starts[axis]
                length = self.sizes[axis]
                if stride >= 1 and 0 <= offset and (
                    offset + stride * (length - 1) < shape[d]
                ):
                    sl = [slice(None)] * value.dim()
                    sl[d] = slice(offset, offset + stride * (length - 1) + 1,
                                  stride)
                    value = value[tuple(sl)]
                    continue
            # monotone grouped reads i // k -> repeat (no gather)
            idx_np = self._static_dim_vector(index, axis)
            if idx_np is not None:
                length = idx_np.shape[0]
                j = shape[d]
                if (
                    j > 0
                    and length % j == 0
                    and length // j > 1
                    and np.array_equal(
                        idx_np, np.repeat(np.arange(j), length // j)
                    )
                ):
                    value = value.repeat_interleave(length // j, dim=d)
                    continue
            idx = self._dim_index_1d(index, axis)
            if idx is None:
                return None
            if not _is_t(idx):
                idx = torch.full((self.sizes[axis],), idx, device=self.device)
            value = value.index_select(d, _wrap_clamp(idx, shape[d]))

        # value dims follow tensor-dim order with sizes L_axis or 1; put the
        # size-1 dims first, then the rest by ascending loop axis
        order = [d for d in range(len(read.dims)) if dep_axes[d] is None] + \
            sorted((d for d in range(len(read.dims))
                    if dep_axes[d] is not None), key=lambda d: dep_axes[d])
        value = value.permute(order)
        out_shape = [1] * self.nloops
        for d, axis in enumerate(dep_axes):
            if axis is not None:
                out_shape[axis] = self.sizes[axis]
        return value.reshape(out_shape)

    def _flat_index(self, op: ir.TensorOp, tensors):
        shape = self.shapes[op.tensor]
        if op.is_raw:
            return self._eval_linear_vec(op.dims[0], tensors)
        flat = 0
        stride = 1
        for dim in range(len(op.dims) - 1, -1, -1):
            flat = flat + self._eval_linear_vec(op.dims[dim], tensors) * stride
            stride *= shape[dim]
        return flat

    def _try_structured_write(self, write: ir.TensorOp, out, out_shape, vals):
        """Scatter-free lowering of structured writes.

        Handles, per write dim (one distinct loop axis each):
        * ``s*i + c`` affine iterators -> (strided) slice update
        * ``i // k`` monotone groupings -> reshape + reduce over the window
        Returns the updated output tensor, or None when scatter is needed.
        """
        if write.is_raw:
            return None
        n = self.nloops
        # per write dim: (loop axis, group k, offset, stride)
        plan: list[tuple[int, int, int, int]] = []
        seen_axes: set[int] = set()
        for d, index in enumerate(write.dims):
            if not index.setup and len(index.factors) == 1:
                (reg, stride), = index.factors.items()
                if stride >= 1 and reg in self.axis_of_reg:
                    axis = self.axis_of_reg[reg]
                    offset = index.constant + stride * self.starts[axis]
                    length = self.sizes[axis]
                    last = offset + stride * (length - 1)
                    if 0 <= offset and last < out_shape[d]:
                        plan.append((axis, 1, offset, stride))
                        seen_axes.add(axis)
                        continue
                return None
            deps = self._linear_deps(index)
            if len(deps) != 1:
                return None
            axis = next(iter(deps))
            length = self.sizes[axis]
            j = out_shape[d]
            if j <= 0 or length % j != 0:
                return None
            k = length // j
            if k == 1:
                return None  # permuted variants stay on scatter
            vec_np = self._static_dim_vector(index, axis)
            if vec_np is None:
                return None
            if vec_np.shape != (length,) or not np.array_equal(
                vec_np, np.repeat(np.arange(j), k)
            ):
                return None
            plan.append((axis, k, 0, 1))
            seen_axes.add(axis)
        if len(seen_axes) != len(plan):
            return None  # repeated axes

        mode = write.accumulate
        # reduce/scale loop axes the write does not touch
        for ax in range(n):
            if ax not in seen_axes and self.sizes[ax] > 1:
                if vals.shape[ax] > 1:
                    vals = _acc_reduce(vals, ax, mode)
                elif mode == "add":
                    vals = vals * self.sizes[ax]

        # group-reduce the windowed axes
        for axis, k, _off, _stride in plan:
            if k == 1:
                continue
            if vals.shape[axis] == 1:
                if mode == "add":
                    vals = vals * k
            else:
                j = self.sizes[axis] // k
                shape = list(vals.shape)
                shape[axis:axis + 1] = [j, k]
                vals = _acc_reduce(vals.reshape(shape), axis + 1, mode,
                                   keepdims=False)

        vals = vals.squeeze(tuple(ax for ax in range(n) if ax not in seen_axes))
        axes = [axis for axis, _k, _o, _s in plan]
        order = sorted(range(len(axes)), key=lambda d: axes[d])
        inv = [0] * len(axes)
        for pos, d in enumerate(order):
            inv[d] = pos
        vals = vals.permute(inv)

        # grouped dims cover the whole output dim; affine dims carry the
        # loop length, placed at the (strided) slice
        region_shape = tuple(
            out_shape[d] if k > 1 else self.sizes[ax]
            for d, (ax, k, _off, _s) in enumerate(plan)
        )
        region = tuple(
            slice(off, off + stride * (length - 1) + 1, stride)
            for (_ax, _k, off, stride), length in zip(plan, region_shape)
        )
        vals = vals.expand(region_shape).to(self.dtype)
        if all(
            off == 0 and stride == 1 and length == out_shape[d]
            for d, ((_ax, _k, off, stride), length) in enumerate(
                zip(plan, region_shape)
            )
        ):
            return _acc_combine(out, vals, mode)
        out = out.clone()
        out[region] = _acc_combine(out[region], vals, mode)
        return out

    def _bounds_mask(self, tensors):
        """Grid mask for dynamic (iterator-dependent) loop bounds, or None:
        True where the point satisfies every dynamic loop's true
        ``[start, stop)``; the static hull's other points contribute the
        accumulation identity."""
        mask = None
        for axis in self.dynamic_axes:
            loop = self.kernel.loops[axis]
            it = self.env[loop.iter_reg]
            lo = self._eval_linear_vec(loop.start, tensors)
            hi = self._eval_linear_vec(loop.stop, tensors)
            m = (it >= lo) & (it < hi)
            mask = m if mask is None else (mask & m)
        return mask

    def _general(self, tensors):
        kernel = self.kernel
        for axis, loop in enumerate(kernel.loops):
            self.env[loop.iter_reg] = self._grid_slot(axis)
        self.eval_instrs(kernel.setup, tensors)
        mask = self._bounds_mask(tensors)
        for read in kernel.reads:
            self.env[read.data] = self._read_value(read, tensors)
        self.eval_instrs(kernel.expr.instrs, tensors)

        write = kernel.write
        assert write is not None and write.data is not None
        mode = write.accumulate
        vals = self._scalar(self.env[write.data])
        if mask is not None:
            vals = torch.where(mask, vals, accumulation_identity(mode))
        if vals.dim() != self.nloops:
            vals = vals.reshape((1,) * (self.nloops - vals.dim())
                                + tuple(vals.shape))

        out = tensors[write.tensor]
        out_shape = self.shapes[write.tensor]

        structured = self._try_structured_write(write, out, out_shape, vals)
        if structured is not None:
            self.sub_path = "structured"
            return structured

        # direct (non-scatter) writes
        if not write.is_raw:
            axes = [self._pure_iter(d) for d in write.dims]
            direct = (
                all(a is not None for a in axes)
                and len(set(axes)) == len(axes)
                and all(
                    self._full_axis(a, out_shape[d])  # type: ignore[arg-type]
                    for d, a in enumerate(axes)
                )
            )
        else:
            axis = self._pure_iter(write.dims[0])
            total = int(np.prod(out_shape, dtype=np.int64))
            direct = axis is not None and self._full_axis(axis, total)
            axes = [axis]

        if direct:
            written = set(axes)
            for ax in range(self.nloops):
                if ax not in written and self.sizes[ax] > 1:
                    if vals.shape[ax] > 1:
                        vals = _acc_reduce(vals, ax, mode)
                    elif mode == "add":
                        vals = vals * self.sizes[ax]
            vals = vals.squeeze(
                tuple(ax for ax in range(self.nloops) if ax not in written)
            )
            # vals axes are ordered by loop axis; permute into write order
            order = sorted(range(len(axes)), key=lambda d: axes[d])
            inv = [0] * len(axes)
            for pos, d in enumerate(order):
                inv[d] = pos
            vals = vals.permute(inv)
            self.sub_path = "direct"
            if write.is_raw:
                flat_vals = vals.expand(out.numel())
                return _acc_combine(out.reshape(-1), flat_vals,
                                    mode).reshape(out.shape)
            return _acc_combine(out, vals.expand(tuple(out_shape)), mode)

        widx = self._flat_index(write, tensors)
        if not _is_t(widx):
            widx = torch.full((), widx, device=self.device)
        if widx.dim() != self.nloops:
            widx = widx.reshape((1,) * (self.nloops - widx.dim())
                                + tuple(widx.shape))
        for ax in range(self.nloops):
            if widx.shape[ax] == 1 and self.sizes[ax] > 1:
                if vals.shape[ax] > 1:
                    vals = _acc_reduce(vals, ax, mode)
                elif mode == "add":
                    vals = vals * self.sizes[ax]
        bshape = torch.broadcast_shapes(widx.shape, vals.shape)
        widx_b = widx.expand(bshape).reshape(-1)
        vals_b = vals.expand(bshape).reshape(-1)
        # out-of-range updates are dropped, as in JAX's scatters: they
        # contribute the identity at a clamped index
        total = out.numel()
        widx_b = torch.where(widx_b < 0, widx_b + total, widx_b)
        valid = (widx_b >= 0) & (widx_b < total)
        vals_b = torch.where(valid, vals_b, accumulation_identity(mode))
        widx_b = widx_b.clamp(0, total - 1)
        self.sub_path = "scatter"
        flat = out.reshape(-1).clone()
        if mode == "add":
            flat.index_put_((widx_b,), vals_b, accumulate=True)
        else:
            flat.scatter_reduce_(0, widx_b, vals_b,
                                 reduce="amax" if mode == "max" else "amin")
        return flat.reshape(out.shape)

    def _run_extern(self, tensors: dict, stats: Optional[dict]) -> str:
        """Run an extern kernel through the port's extern table; returns
        its lowering path, ``extern:<name>``.

        ``self.extern_memo`` (one dict per target run) is shared across the
        kernels of one multi-output call, so the op runs once."""
        ext = self.kernel.extern
        assert ext is not None and self.kernel.write is not None
        key = ext.key()
        if key not in self.extern_memo:
            edef = get_extern(ext.name)
            args = [tensors[tid] for tid in ext.inputs]
            ctx = ExternContext(stats=stats, policy=self.policy)
            result = edef.torch_fn(args, dict(ext.attrs), ctx)
            if not isinstance(result, tuple):
                result = (result,)
            if len(result) != ext.nout:
                raise ModelRuntimeError(
                    f"extern op {ext.name!r} returned {len(result)} "
                    f"outputs, but the graph expects {ext.nout}"
                )
            self.extern_memo[key] = result
        value = self.extern_memo[key][ext.out_index].to(self.dtype)
        out_tid = self.kernel.write.tensor
        expect = tuple(self.shapes[out_tid])
        if tuple(value.shape) != expect:
            raise ModelRuntimeError(
                f"extern op {ext.name!r} output {ext.out_index} has shape "
                f"{tuple(value.shape)}, but tensor t{out_tid} has shape "
                f"{expect} (check the with_shape/copy_shape annotation)"
            )
        tensors[out_tid] = tensors[out_tid] + value
        return f"extern:{ext.name}"

    def _kernel_desc(self) -> str:
        write = self.kernel.write
        name = (
            self.program.tensors[write.tensor].name
            if write is not None
            else "?"
        )
        return f"the kernel writing {name or '?'!r}"

    # ------------------------------------------------------------------
    def scheduled_matmul(self) -> ScheduledMatmul:
        """Kernel B1's classification of this kernel (made once)."""
        if self._matmul is None:
            self._matmul = ScheduledMatmul(self, self.kernel)
        return self._matmul

    def scheduled_mapreduce(self) -> ScheduledMapReduce:
        """Kernel B5's classification of this kernel (made once)."""
        if self._mapreduce is None:
            self._mapreduce = ScheduledMapReduce(self, self.kernel)
        return self._mapreduce

    def conv_match(self) -> ConvMatch:
        """The convolution classification of this kernel (made once)."""
        if self._conv is None:
            self._conv = ConvMatch(self, self.kernel)
        return self._conv

    def _general_only(self) -> bool:
        """add-accumulation with static bounds is required by the einsum
        matcher and the matmul kernel; dynamic bounds need the general
        path's hull mask"""
        return (self.kernel.write.accumulate != "add"
                or bool(self.dynamic_axes))

    def scheduled_route(self):
        """The scheduled kernel this kernel runs: ``"matmul"`` (B1),
        ``"mapreduce"`` (B5, generated), or None."""
        return self.scheduled_decision()[0]

    def scheduled_decision(self):
        """``(route, fallback reason)``, decided once, as the JAX
        package's ``KernelLowering.run`` decides: a kernel B1 accepts asks
        ``policy.contraction``; any other ``policy.mapreduce`` with the
        classifier's byte counts.  The route is None, and the reason too,
        when the kernel is not scheduled or the policy ignores schedules;
        the route is None with a reason when the cost model or both
        classifiers send a scheduled kernel to the plain lowering."""
        if self._decision is not None:
            return self._decision
        route = reason = None
        if is_scheduled(self.kernel) and self.policy.routes_schedules:
            sm = None
            if not self._general_only():
                sm = self.scheduled_matmul()
                if sm.ok:
                    decision = self.contraction_decision(sm)
                    if decision.use_pallas:
                        route = "matmul"
                    else:
                        reason = decision.reason
            if route is None and reason is None:
                mr = self.scheduled_mapreduce()
                if mr.ok:
                    decision = self.policy.mapreduce(mr.total_bytes,
                                                     mr.gather_work * 4)
                    if decision.use_pallas:
                        route = "mapreduce"
                    else:
                        reason = decision.reason
                else:
                    # a matmul-shaped kernel that B1 declined late
                    # (transposed operands) reports that cause, not the
                    # map/reduce classifier's generic "contraction"
                    why = mr.why
                    if (sm is not None and why.startswith("contraction")
                            and ("tile sizes" in sm.why
                                 or "transposed" in sm.why)):
                        why = sm.why
                    reason = f"unsupported kernel shape ({why})"
        self._decision = (route, reason)
        return self._decision

    def run_plain(self, tensors: dict, epoch: int):
        """The new value of the kernel's output by its plain lowering (the
        einsum or the general paths): the plain version of kernel B5."""
        self.epoch = epoch
        found = None if self._general_only() else self._try_contraction(
            tensors, route=False)
        result = found[0] if found is not None else None
        if result is None:
            self.sub_path = "unknown"
            result = self._general(tensors)
        self.env = {}  # the executor keeps this lowering; free the run's grids
        return result

    def run(self, tensors: dict, epoch: int,
            stats: Optional[dict] = None) -> Optional[str]:
        """Execute the kernel, replacing ``tensors[write.tensor]``;
        returns its lowering path as ``lowering_stats`` counts it (None
        when the kernel's bounds are empty and nothing ran).

        ``stats`` is given on an executor's first run only: it counts the
        recompute kernels and the fallbacks, and gates the schedule
        warning, so they report once per compiled executor, as the JAX
        package reports once per trace; the caller counts the path."""
        if self.kernel.extern is not None:
            return self._run_extern(tensors, stats)
        if not self._bounds_ok:
            return None
        self.epoch = epoch
        assert self.kernel.write is not None
        if self.kernel.remat and stats is not None:
            # recompute kernels need no fence in eager execution: nothing
            # can hoist or merge them; the stat still counts them
            stats["remat"] = stats.get("remat", 0) + 1
        general_only = self._general_only()
        result = None
        path = "einsum"
        route, fallback_reason = self.scheduled_decision()
        if route == "matmul":
            path = "matmul"
            result = self.scheduled_matmul().lower(tensors)
        elif route == "mapreduce":
            path = "mapreduce"
            result = self.scheduled_mapreduce().lower(tensors)
        conv_decline = None
        if result is None and not general_only:
            found = self._try_contraction(tensors)
            if found is not None:
                result, how = found
                if how == "einsum-b1":
                    path = how
        if result is None and not general_only:
            match = self.conv_match()
            if match.ok:
                path = "conv"
                result = tensors[self.kernel.write.tensor] + match.lower(
                    tensors)
            else:
                conv_decline = match.why
        if result is None:
            self.sub_path = "unknown"
            result = self._general(tensors)
            path = f"general-{self.sub_path}"
        if stats is not None:
            for reason in (fallback_reason, conv_decline):
                if reason is not None:
                    self.policy.fallback(stats, self._kernel_desc(),
                                         f"{reason}; lowered via {path}")
        tensors[self.kernel.write.tensor] = result
        self.env = {}  # the executor keeps this lowering; free the run's grids
        return path
