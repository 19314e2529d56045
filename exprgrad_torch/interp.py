"""Vectorized numpy reference interpreter for compiled programs.

This is the *oracle* backend: a direct, dependency-free execution of the
structured kernel IR used to validate the XLA/Pallas backend numerically,
playing the role the LLVM-JIT CPU path plays for the reference's GPU tests
(tests/test_gpu.nim:57-68 compares GPU results against the CPU JIT).

Execution model per kernel: materialize the loop nest as a broadcasted grid
(one numpy axis per loop), evaluate the scalar expression once over the whole
grid, then accumulate into the written tensor — summing over loop axes the
write index does not depend on, and scatter-adding (``np.add.at``) when the
write index varies over them.  This matches the reference semantics of
``+=`` accumulation over nested loops (README.md:98-119) exactly, including
gradient scatter-adds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import ir
from .errors import ModelRuntimeError, ShapeError
from .ir import Kernel, LinearIndex, Op, Program
from .passes.shapes import resolve_loop_bounds


def extreme_accumulated_results(target) -> dict:
    """tid -> "max" | "min" for result tensors written exclusively with one
    extreme accumulation mode; these initialize to -inf / +inf."""
    modes: dict[int, set[str]] = {}
    for kernel in target.kernels:
        if kernel.write is not None:
            modes.setdefault(kernel.write.tensor, set()).add(
                kernel.write.accumulate
            )
    return {
        tid: next(iter(m))
        for tid, m in modes.items()
        if m == {"max"} or m == {"min"}
    }


def accumulation_identity(mode: str) -> float:
    return {"add": 0.0, "max": -np.inf, "min": np.inf}[mode]


class _ArrayVal:
    """A (possibly grid-varying) fixed-size array value.

    ``data`` has shape (grid broadcast dims...) + array dims, where the last
    ``array_ndim`` axes are the array axes.
    """

    __slots__ = ("data", "array_ndim")

    def __init__(self, data: np.ndarray, array_ndim: int) -> None:
        self.data = data
        self.array_ndim = array_ndim


def _trunc_div(a, b):
    q = np.floor_divide(a, b)
    r = a - q * b
    # floored -> truncated: where operand signs differ and there is a
    # nonzero remainder, the floored quotient is one below the truncated
    # one.  (The remainder of floored division always carries the
    # divisor's sign, so the dividend sign must be consulted directly.)
    adjust = (r != 0) & ((np.asarray(a) < 0) != (np.asarray(b) < 0))
    return q + adjust


def _trunc_mod(a, b):
    return a - _trunc_div(a, b) * b


class _KernelEval:
    def __init__(
        self,
        program: Program,
        kernel: Kernel,
        shapes: dict[int, list[int]],
        tensors: dict[int, np.ndarray],
        epoch: int,
        dtype: np.dtype,
    ) -> None:
        self.program = program
        self.kernel = kernel
        self.shapes = shapes
        self.tensors = tensors
        self.epoch = epoch
        self.dtype = dtype
        self.env: dict[int, object] = {}
        self.nloops = len(kernel.loops)
        self.sizes: list[int] = []
        self.dynamic_axes: list[int] = []

    # --- loop bounds --------------------------------------------------
    def eval_bounds(self) -> bool:
        """Returns False when the iteration space is empty.

        Loops whose bounds reference other iterators (triangular loops)
        resolve to their static interval hull; ``self.dynamic_axes`` marks
        them and ``run`` masks grid points outside the true bounds.
        """
        for loop in self.kernel.loops:
            if not loop.has_bounds:
                raise ModelRuntimeError(
                    "loop range could not be inferred; use a bounded iterator "
                    "like irange(name, start, stop)"
                )
            assert loop.step == 1
        try:
            self.starts, self.sizes, self.dynamic_axes = resolve_loop_bounds(
                self.kernel.loops, self.shapes, self.epoch
            )
        except ShapeError as err:
            raise ModelRuntimeError(str(err)) from err
        if any(s == 0 for s in self.sizes):
            return False
        for axis, loop in enumerate(self.kernel.loops):
            shape = [1] * self.nloops
            shape[axis] = self.sizes[axis]
            self.env[loop.iter_reg] = (
                np.arange(self.starts[axis], self.starts[axis] + self.sizes[axis])
                .reshape(shape)
            )
        return True

    # --- instruction evaluation --------------------------------------
    def eval_instrs(self, instrs: list[ir.Instr]) -> None:
        env = self.env
        dtype = self.dtype
        for instr in instrs:
            op = instr.op
            a = [env[x] for x in instr.args]
            if op == Op.IDX:
                value = instr.index_lit
            elif op == Op.SCALAR:
                value = dtype.type(instr.scalar_lit)
            elif op == Op.BOOL:
                value = instr.bool_lit
            elif op == Op.ADD:
                value = a[0] + a[1]
            elif op == Op.SUB:
                value = a[0] - a[1]
            elif op == Op.MUL:
                value = a[0] * a[1]
            elif op == Op.DIV:
                # derived gradients legitimately divide by values that are
                # zero at masked/unreached grid points (e.g. d/dx log x
                # evaluated where select() discards the result); keep the
                # oracle warning-clean so real divergences stand out
                with np.errstate(divide="ignore", invalid="ignore"):
                    value = a[0] / a[1]
            elif op == Op.IDX_DIV:
                value = _trunc_div(a[0], a[1])
            elif op == Op.MOD:
                value = _trunc_mod(a[0], a[1])
            elif op == Op.WRAP:
                value = np.mod(a[0], a[1])
            elif op == Op.NEG:
                value = -a[0] if not isinstance(a[0], bool) else not a[0]
            elif op == Op.SIN:
                value = np.sin(a[0])
            elif op == Op.COS:
                value = np.cos(a[0])
            elif op == Op.EXP:
                value = np.exp(a[0])
            elif op == Op.POW:
                value = np.power(a[0], a[1])
            elif op == Op.SQRT:
                value = np.sqrt(a[0])
            elif op == Op.LN:
                value = np.log(a[0])
            elif op == Op.LOG:
                value = np.log(a[0]) / np.log(a[1])
            elif op == Op.LOG2:
                value = np.log2(a[0])
            elif op == Op.LOG10:
                value = np.log10(a[0])
            elif op == Op.EQ:
                value = a[0] == a[1]
            elif op == Op.LT:
                value = a[0] < a[1]
            elif op == Op.LE:
                value = a[0] <= a[1]
            elif op == Op.AND:
                value = np.logical_and(a[0], a[1])
            elif op == Op.OR:
                value = np.logical_or(a[0], a[1])
            elif op == Op.SELECT:
                value = np.where(a[0], a[1], a[2])
                if np.ndim(value) == 0 and not isinstance(a[1], _ArrayVal):
                    value = value[()]
            elif op == Op.TO_SCALAR:
                value = np.asarray(a[0]).astype(dtype)
                if np.ndim(value) == 0:
                    value = value[()]
            elif op == Op.TO_INDEX:
                value = np.trunc(np.asarray(a[0])).astype(np.int64)
                if np.ndim(value) == 0:
                    value = int(value)
            elif op == Op.SHAPE:
                value = self.shapes[instr.tensor][instr.dim]
            elif op == Op.LEN:
                value = int(np.prod(self.shapes[instr.tensor], dtype=np.int64))
            elif op == Op.SHAPE_LEN:
                value = len(self.shapes[instr.tensor])
            elif op == Op.EPOCH:
                value = self.epoch
            elif op in (Op.DEBUG_SCALAR, Op.DEBUG_INDEX):
                print(f"{instr.label}: {np.asarray(a[0])}", flush=True)
                value = a[0]
            elif op == Op.ARRAY:
                value = self._make_array(a)
            elif op == Op.ARRAY_LEN:
                av = a[0]
                assert isinstance(av, _ArrayVal)
                value = av.data.shape[av.data.ndim - av.array_ndim]
            elif op == Op.ARRAY_READ:
                value = self._array_read(a[0], a[1])
            else:
                raise ModelRuntimeError(f"cannot interpret {op.value}")
            if instr.res is not None:
                env[instr.res] = value

    def _make_array(self, items: list) -> _ArrayVal:
        if items and isinstance(items[0], _ArrayVal):
            inner_ndim = items[0].array_ndim
            data = np.stack(
                [it.data for it in items], axis=-inner_ndim - 1  # type: ignore[union-attr]
            )
            return _ArrayVal(data, inner_ndim + 1)
        data = np.stack([np.broadcast_to(np.asarray(v, self.dtype), ()) if np.ndim(v) == 0 else np.asarray(v) for v in items], axis=-1)
        # normalize: grid axes first, one trailing array axis
        return _ArrayVal(data, 1)

    def _array_read(self, av, idx):
        assert isinstance(av, _ArrayVal)
        axis = av.data.ndim - av.array_ndim
        if isinstance(idx, (int, np.integer)):
            data = np.take(av.data, int(idx), axis=axis)
            if av.array_ndim == 1:
                return data if data.ndim > 0 else data[()]
            return _ArrayVal(data, av.array_ndim - 1)
        idx = np.asarray(idx)
        # expand grid part of data to match idx's grid dims
        grid_shape = np.broadcast_shapes(av.data.shape[:axis], idx.shape)
        data = np.broadcast_to(
            av.data, grid_shape + av.data.shape[axis:]
        )
        axis = data.ndim - av.array_ndim
        idx_e = np.broadcast_to(
            idx.reshape(idx.shape + (1,) * av.array_ndim),
            grid_shape + (1,) + data.shape[axis + 1:],
        )
        taken = np.take_along_axis(data, idx_e, axis=axis)
        taken = np.squeeze(taken, axis=axis)
        if av.array_ndim == 1:
            return taken
        return _ArrayVal(taken, av.array_ndim - 1)

    # --- tensor access ------------------------------------------------
    def _flat_index(self, op: ir.TensorOp):
        """Flat element index of a tensor access, as a broadcastable array."""
        shape = self.shapes[op.tensor]
        if op.is_raw:
            return self._eval_linear_vec(op.dims[0])
        flat = 0
        stride = 1
        for dim in range(len(op.dims) - 1, -1, -1):
            flat = flat + self._eval_linear_vec(op.dims[dim]) * stride
            stride *= shape[dim]
        return flat

    def _eval_linear_vec(self, index: LinearIndex):
        self.eval_instrs(index.setup)
        value = index.constant
        for reg, factor in index.factors.items():
            value = value + self.env[reg] * factor
        return value

    def _bounds_mask(self):
        """Grid mask for dynamic (iterator-dependent) loop bounds, or None.

        The grid iterates each dynamic loop's static hull; points outside
        the true per-point ``[start, stop)`` contribute the accumulation
        identity instead.
        """
        mask = None
        for axis in self.dynamic_axes:
            loop = self.kernel.loops[axis]
            it = self.env[loop.iter_reg]
            lo = self._eval_linear_vec(loop.start)
            hi = self._eval_linear_vec(loop.stop)
            m = (it >= lo) & (it < hi)
            mask = m if mask is None else (mask & m)
        return mask

    # --- kernel execution --------------------------------------------
    def run(self) -> None:
        kernel = self.kernel
        if not self.eval_bounds():
            return
        self.eval_instrs(kernel.setup)
        mask = self._bounds_mask()
        for read in kernel.reads:
            flat = self._flat_index(read)
            data = self.tensors[read.tensor].reshape(-1)
            if mask is not None:
                # hull points outside the true bounds may index out of
                # range; clamp (their contribution is masked to identity)
                flat = np.clip(flat, 0, data.shape[0] - 1)
            self.env[read.data] = data[flat]
        self.eval_instrs(kernel.expr.instrs)

        write = kernel.write
        assert write is not None and write.data is not None
        vals = self.env[write.data]
        if mask is not None:
            identity = accumulation_identity(write.accumulate)
            vals = np.where(mask, vals, self.dtype.type(identity))
        widx = self._flat_index(write)
        if mask is not None:
            size = int(np.prod(self.shapes[write.tensor], dtype=np.int64))
            widx = np.clip(widx, 0, size - 1)

        full = tuple(self.sizes)
        n = self.nloops
        widx = np.asarray(widx)
        if widx.ndim == 0:
            widx = widx.reshape((1,) * n)
        vals = np.asarray(vals, dtype=self.dtype)
        if vals.ndim == 0:
            vals = vals.reshape((1,) * n)

        mode = write.accumulate
        # reduce over loop axes the write index does not vary over
        for axis in range(n):
            if widx.shape[axis] == 1 and full[axis] > 1:
                if vals.shape[axis] > 1:
                    if mode == "add":
                        vals = vals.sum(axis=axis, keepdims=True)
                    elif mode == "max":
                        vals = vals.max(axis=axis, keepdims=True)
                    else:
                        vals = vals.min(axis=axis, keepdims=True)
                elif mode == "add":
                    vals = vals * self.dtype.type(full[axis])

        out = self.tensors[write.tensor]
        flat = out.reshape(-1)
        bshape = np.broadcast_shapes(widx.shape, vals.shape)
        widx_b = np.broadcast_to(widx, bshape).reshape(-1)
        vals_b = np.broadcast_to(vals, bshape).reshape(-1)
        acc = flat.astype(self.dtype, copy=True)
        ufunc = {"add": np.add, "max": np.maximum, "min": np.minimum}[mode]
        ufunc.at(acc, widx_b, vals_b)
        self.tensors[write.tensor] = acc.reshape(out.shape)


def run_target(
    program: Program,
    target_name: str,
    shapes: dict[int, list[int]],
    tensors: dict[int, np.ndarray],
    epoch: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> dict[int, np.ndarray]:
    """Execute one target; mutates and returns ``tensors`` (id -> array)."""
    target = program.targets[target_name]
    dtype = np.dtype(program.scalar_type.value)
    extreme = extreme_accumulated_results(target)
    for tid in sorted(target.tensors):
        tdef = program.tensors[tid]
        if tdef.kind == ir.TensorKind.RESULT:
            if tid in extreme:
                tensors[tid] = np.full(
                    shapes[tid],
                    accumulation_identity(extreme[tid]),
                    dtype=dtype,
                )
            else:
                tensors[tid] = np.zeros(shapes[tid], dtype=dtype)
        elif tdef.kind == ir.TensorKind.RANDOM:
            if rng is None:
                rng = np.random.default_rng(0)
            lo, hi = tdef.random_range
            tensors[tid] = rng.uniform(lo, hi, size=shapes[tid]).astype(dtype)
    extern_memo: dict = {}
    for kernel in target.kernels:
        assert kernel.generator.kind == ir.GenKind.NONE, (
            "generator kernels must be expanded before execution"
        )
        if kernel.extern is not None:
            _run_extern(kernel, tensors, extern_memo, dtype)
            continue
        _KernelEval(program, kernel, shapes, tensors, epoch, dtype).run()
    return tensors


def _run_extern(
    kernel: Kernel, tensors: dict, memo: dict, dtype: np.dtype
) -> None:
    """Evaluate an extern kernel via the port's registered implementation,
    on CPU tensors (the kernels' plain versions).

    All outputs of one logical call share a memo entry so multi-output ops
    (e.g. attention's (out, logsumexp)) compute once per target run.
    """
    import torch

    from .registry import ExternContext, get_extern

    ext = kernel.extern
    assert ext is not None and kernel.write is not None
    key = ext.key()
    if key not in memo:
        edef = get_extern(ext.name)
        args = [torch.from_numpy(np.ascontiguousarray(tensors[tid]))
                for tid in ext.inputs]
        result = edef.torch_fn(args, dict(ext.attrs), ExternContext())
        if not isinstance(result, tuple):
            result = (result,)
        result = tuple(r.numpy() for r in result)
        if len(result) != ext.nout:
            raise ModelRuntimeError(
                f"extern op {ext.name!r} returned {len(result)} outputs, "
                f"but the graph expects {ext.nout}"
            )
        memo[key] = result
    value = np.asarray(memo[key][ext.out_index], dtype=dtype)
    out = tensors[kernel.write.tensor]
    if value.shape != out.shape:
        raise ModelRuntimeError(
            f"extern op {ext.name!r} output {ext.out_index} has shape "
            f"{value.shape}, but tensor t{kernel.write.tensor} has shape "
            f"{out.shape} (check the with_shape/copy_shape annotation)"
        )
    tensors[kernel.write.tensor] = out + value
