"""Shape-constraint inference, ordering and (static + runtime) solving.

Parity: reference ``inferShapeConstraints`` (passes.nim:1059-1117),
``sortShapeConstraints`` (passes.nim:1169-1221), the rational-arithmetic
linear solver ``solve`` (passes.nim:1252-1323), compile-time
``inferStaticShapes`` (passes.nim:1444-1517) and runtime ``inferShapes``
(passes.nim:1386-1436).

The solver here computes a reduced row echelon form over ``fractions.Fraction``
and extracts *uniquely determined* variables, which makes static inference
robust to partially-known systems instead of raising mid-pass.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence

from .. import ir
from ..errors import ShapeError
from ..ir import (
    ALL_STAGES,
    Instr,
    Kernel,
    LinearIndex,
    Op,
    Program,
    ShapeConstrKind,
    ShapeConstrPriority,
    ShapeConstraint,
    Stage,
)


# ---------------------------------------------------------------------------
# integer semantics helpers (Nim div/mod are truncated; numpy's are floored)
# ---------------------------------------------------------------------------

def trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def trunc_mod(a: int, b: int) -> int:
    return a - trunc_div(a, b) * b


# ---------------------------------------------------------------------------
# compile/run-time evaluation of index instructions
# ---------------------------------------------------------------------------

def eval_instrs(
    instrs: Sequence[Instr],
    shapes: dict[int, list[int]],
    regs: dict[int, int],
    epoch: Optional[int] = None,
) -> bool:
    """Evaluate Index-typed instructions given known tensor shapes.

    Returns False when a value cannot be determined (unknown shape / dynamic
    register); reference ``eval`` (passes.nim:1328-1374).
    """
    for instr in instrs:
        if any(a not in regs for a in instr.args):
            return False
        if instr.tensor is not None and instr.op in (Op.SHAPE, Op.LEN, Op.SHAPE_LEN):
            if instr.tensor not in shapes:
                return False
        op = instr.op
        a = [regs[x] for x in instr.args]
        if op == Op.SHAPE:
            shape = shapes[instr.tensor]
            if not shape:
                return False
            size = shape[instr.dim]  # python negative indexing = reference ^i
            if size < 0:
                return False
            value = size
        elif op == Op.LEN:
            shape = shapes[instr.tensor]
            if not shape or any(s < 0 for s in shape):
                return False
            value = 1
            for s in shape:
                value *= s
        elif op == Op.SHAPE_LEN:
            shape = shapes[instr.tensor]
            if not shape:
                return False
            value = len(shape)
        elif op == Op.IDX:
            value = instr.index_lit
        elif op == Op.ADD:
            value = a[0] + a[1]
        elif op == Op.SUB:
            value = a[0] - a[1]
        elif op == Op.MUL:
            value = a[0] * a[1]
        elif op == Op.IDX_DIV:
            value = trunc_div(a[0], a[1])
        elif op == Op.MOD:
            value = trunc_mod(a[0], a[1])
        elif op == Op.WRAP:
            value = a[0] % a[1] if a[1] > 0 else -((-a[0]) % (-a[1]))
        elif op == Op.NEG:
            value = -a[0]
        elif op == Op.EPOCH:
            if epoch is None:
                return False
            value = epoch
        else:
            raise ShapeError(f"invalid instruction {op.value} in index expression")
        assert instr.res is not None
        regs[instr.res] = value
    return True


def eval_linear(
    index: LinearIndex,
    shapes: dict[int, list[int]],
    epoch: Optional[int] = None,
) -> Optional[int]:
    regs: dict[int, int] = {}
    if not eval_instrs(index.setup, shapes, regs, epoch):
        return None
    try:
        return index.eval(regs)
    except KeyError:
        return None


# ---------------------------------------------------------------------------
# interval evaluation (for iterator-dependent loop bounds)
# ---------------------------------------------------------------------------

def eval_linear_interval(
    index: LinearIndex,
    shapes: dict[int, list[int]],
    reg_intervals: dict[int, ir.Interval],
    epoch: Optional[int] = None,
) -> Optional[ir.Interval]:
    """Interval hull of a linear index whose registers span known ranges.

    Used to bound loops whose start/stop reference other iterators
    (triangular loops, the reference's arbitrary ``(x in a..<b)`` bound
    expressions, parser.nim:615-633): the backends iterate the static hull
    and mask out-of-bound points.  Returns None when an instruction cannot
    be bounded.
    """
    env: dict[int, ir.Interval] = dict(reg_intervals)

    def _mul(x: ir.Interval, y: ir.Interval) -> ir.Interval:
        corners = [x.min * y.min, x.min * y.max, x.max * y.min, x.max * y.max]
        return ir.Interval(min(corners), max(corners))

    for instr in index.setup:
        if any(a not in env for a in instr.args):
            return None
        a = [env[x] for x in instr.args]
        op = instr.op
        if op == Op.IDX:
            value = ir.Interval(instr.index_lit, instr.index_lit)
        elif op == Op.ADD:
            value = a[0] + a[1]
        elif op == Op.SUB:
            value = a[0] + a[1].scaled(-1)
        elif op == Op.MUL:
            value = _mul(a[0], a[1])
        elif op == Op.NEG:
            value = a[0].scaled(-1)
        elif op == Op.IDX_DIV:
            if a[1].min <= 0:
                return None  # divisor may be zero/negative: give up
            corners = [
                trunc_div(a[0].min, a[1].min),
                trunc_div(a[0].min, a[1].max),
                trunc_div(a[0].max, a[1].min),
                trunc_div(a[0].max, a[1].max),
            ]
            value = ir.Interval(min(corners), max(corners))
        elif op == Op.MOD:
            if a[1].min <= 0:
                return None
            value = ir.Interval(min(0, a[0].min), a[1].max - 1)
        elif op == Op.WRAP:
            if a[1].min <= 0:
                return None
            value = ir.Interval(0, a[1].max - 1)
        elif op == Op.SHAPE:
            if instr.tensor not in shapes or not shapes[instr.tensor]:
                return None
            size = shapes[instr.tensor][instr.dim]
            if size < 0:
                return None
            value = ir.Interval(size, size)
        elif op == Op.LEN:
            shape = shapes.get(instr.tensor)
            if not shape or any(s < 0 for s in shape):
                return None
            total = 1
            for s in shape:
                total *= s
            value = ir.Interval(total, total)
        elif op == Op.SHAPE_LEN:
            if instr.tensor not in shapes:
                return None
            rank = len(shapes[instr.tensor])
            value = ir.Interval(rank, rank)
        elif op == Op.EPOCH:
            if epoch is None:
                return None
            value = ir.Interval(epoch, epoch)
        else:
            return None
        if instr.res is not None:
            env[instr.res] = value

    result = ir.Interval(index.constant, index.constant)
    for reg, factor in index.factors.items():
        if reg not in env:
            return None
        result = result + env[reg].scaled(factor)
    return result


def resolve_loop_bounds(
    loops,
    shapes: dict[int, list[int]],
    epoch: Optional[int] = None,
) -> tuple[list[int], list[int], list[int]]:
    """Resolve per-loop (start, size) with dynamic-bound support.

    Static bounds evaluate exactly.  Bounds referencing other iterators
    resolve to their interval hull over the referenced loops' ranges, and
    the loop's axis is reported as *dynamic*: the backend must iterate the
    hull and mask points outside ``[start_expr, stop_expr)``.

    Returns (starts, sizes, dynamic_axes); raises ShapeError when a bound
    cannot be resolved at all.
    """
    n = len(loops)
    starts: list[Optional[int]] = [None] * n
    sizes: list[Optional[int]] = [None] * n
    dynamic: list[int] = []
    intervals: dict[int, ir.Interval] = {}

    unresolved = []
    for axis, loop in enumerate(loops):
        start = eval_linear(loop.start, shapes, epoch)
        stop = eval_linear(loop.stop, shapes, epoch)
        if start is not None and stop is not None:
            starts[axis] = start
            sizes[axis] = max(0, stop - start)
            intervals[loop.iter_reg] = ir.Interval(start, max(start, stop - 1))
        else:
            unresolved.append(axis)

    # iterate: a dynamic bound may reference another dynamic loop's hull
    progress = True
    while unresolved and progress:
        progress = False
        still = []
        for axis in unresolved:
            loop = loops[axis]
            lo = eval_linear_interval(loop.start, shapes, intervals, epoch)
            hi = eval_linear_interval(loop.stop, shapes, intervals, epoch)
            if lo is None or hi is None:
                still.append(axis)
                continue
            starts[axis] = lo.min
            sizes[axis] = max(0, hi.max - lo.min)
            intervals[loop.iter_reg] = ir.Interval(
                lo.min, max(lo.min, hi.max - 1)
            )
            dynamic.append(axis)
            progress = True
        unresolved = still

    if unresolved:
        raise ShapeError(
            "unable to evaluate loop bounds (unresolvable dynamic bound)"
        )
    dynamic.sort()
    return starts, sizes, dynamic  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# linear solver
# ---------------------------------------------------------------------------

def solve_partial(equations: list[LinearIndex]) -> dict[int, Fraction]:
    """Solve ``{index expr == 0}`` for every uniquely determined register.

    Each equation is an affine form set equal to zero.  Returns a mapping of
    registers whose value is forced by the system.  Raises ShapeError when the
    system is inconsistent.  (Reference ``solve``, passes.nim:1252-1323,
    which required a square system; partial solving is strictly stronger.)
    """
    regs = sorted({r for eq in equations for r in eq.factors})
    if not regs:
        for eq in equations:
            if not eq.factors and eq.constant != 0:
                raise ShapeError("shape constraints have no solution")
        return {}
    col = {r: i for i, r in enumerate(regs)}
    n = len(regs)
    rows: list[list[Fraction]] = []
    for eq in equations:
        row = [Fraction(0)] * (n + 1)
        for r, f in eq.factors.items():
            row[col[r]] = Fraction(f)
        row[n] = Fraction(-eq.constant)
        rows.append(row)

    # reduced row echelon form
    pivot_cols: list[int] = []
    r = 0
    for c in range(n):
        pivot = next((i for i in range(r, len(rows)) if rows[i][c] != 0), None)
        if pivot is None:
            continue
        rows[r], rows[pivot] = rows[pivot], rows[r]
        pv = rows[r][c]
        rows[r] = [v / pv for v in rows[r]]
        for i in range(len(rows)):
            if i != r and rows[i][c] != 0:
                f = rows[i][c]
                rows[i] = [v - f * p for v, p in zip(rows[i], rows[r])]
        pivot_cols.append(c)
        r += 1
        if r == len(rows):
            break

    for i in range(r, len(rows)):
        if all(v == 0 for v in rows[i][:n]) and rows[i][n] != 0:
            raise ShapeError("shape constraints have no solution")

    out: dict[int, Fraction] = {}
    for i, c in enumerate(pivot_cols):
        if all(rows[i][c2] == 0 for c2 in range(n) if c2 != c):
            out[regs[c]] = rows[i][n]
    return out


def solve_floor(equations: list[LinearIndex]) -> Optional[dict[int, int]]:
    """Floor-bound fallback for inconsistent read-extent systems.

    The exact solver demands every read's max index reach size-1 exactly
    (reference passes.nim:1252).  That rejects legitimate strided reads
    whose loop bound is pinned elsewhere: ``out[i] = base[i] + t[2*i]``
    with ``base`` of length L and ``t`` of length 2L yields the conflicting
    equations ``i == L-1`` and ``2*i == 2L-1``.  Here we retry with floor
    semantics: a stride-f read may stop up to f-1 elements short of the
    end (it must still be unable to take one more step), while unit-stride
    reads keep exact-cover semantics — so plain elementwise size mismatches
    (``a`` of 5 vs ``b`` of 7) remain errors.

    Concretely every single-register equation ``f*r + c == 0`` (f > 0)
    implies the bound ``r == (-c) // f``; all bounds for a register must
    agree.  Multi-register equations are resolved by substitution once all
    but one register are known, and checked with the same slack rule.
    Returns None when the relaxation does not apply (no stride > 1
    anywhere, negative strides, bounds that disagree, negative iterator
    maxima); the caller then re-raises the exact solver's error.
    """
    values: dict[int, int] = {}
    any_strided = False

    def assign(reg: int, f: int, rhs: int) -> bool:
        nonlocal any_strided
        if f <= 0:
            return False
        val = rhs // f
        if val < 0:
            return False
        if f > 1:
            any_strided = True
        prev = values.get(reg)
        if prev is None:
            values[reg] = val
            return True
        return prev == val

    pending: list[LinearIndex] = []
    for eq in equations:
        regs = [r for r, f in eq.factors.items() if f != 0]
        if not regs:
            if eq.constant != 0:
                return None
            continue
        if len(regs) == 1:
            r = regs[0]
            if not assign(r, eq.factors[r], -eq.constant):
                return None
        else:
            pending.append(eq)

    # substitute known registers into multi-register equations until fixed
    progress = True
    while pending and progress:
        progress = False
        still: list[LinearIndex] = []
        for eq in pending:
            unknown = [r for r, f in eq.factors.items() if f != 0 and r not in values]
            if len(unknown) > 1:
                still.append(eq)
                continue
            rhs = -eq.constant - sum(
                f * values[r]
                for r, f in eq.factors.items()
                if f != 0 and r in values
            )
            if not unknown:
                # fully determined: residual must sit inside the stride slack
                strides = [f for f in eq.factors.values() if f != 0]
                if any(f <= 0 for f in strides):
                    return None
                if not (0 <= rhs < max(strides)):
                    return None
                if max(strides) > 1:
                    any_strided = True
            elif not assign(unknown[0], eq.factors[unknown[0]], rhs):
                return None
            progress = True
        pending = still

    if pending or not any_strided:
        # dependent multi-register subsystem we cannot order, or a pure
        # unit-stride conflict (a genuine size mismatch): don't relax
        return None
    return values


# ---------------------------------------------------------------------------
# constraint inference
# ---------------------------------------------------------------------------

def _simplify_max_index(indices: list[LinearIndex]) -> list[LinearIndex]:
    """Among same-direction affine indices keep the max constant offset.

    E.g. reads a[x], a[x+1], a[x+2] constrain x+2 <= size-1
    (reference simplifyMaxIndex, passes.nim:1040-1057).
    """
    max_constants: dict[tuple, int] = {}
    complex_indices: list[LinearIndex] = []
    for index in indices:
        if not index.setup:
            key = index.factors_key()
            if key not in max_constants:
                max_constants[key] = index.constant
            else:
                max_constants[key] = max(max_constants[key], index.constant)
        else:
            complex_indices.append(index)
    out = list(complex_indices)
    for key, constant in max_constants.items():
        out.append(LinearIndex(factors=dict(key), constant=constant))
    return out


def _kernel_constraints(kernel: Kernel) -> list[ShapeConstraint]:
    out: list[ShapeConstraint] = []
    assert kernel.write is not None
    if kernel.write.is_raw:
        src: Optional[int] = None
        if len(kernel.reads) == 1:
            src = kernel.reads[0].tensor
        else:
            # multi-read raw write: copy the shape of a read indexed by
            # the write's own identity index ({it} -> {it}) — the shared
            # iterator extent pins both flat sizes, so the elementwise
            # operand determines the result shape even when other reads
            # (broadcast scalars like a global grad-norm) join the kernel
            w = kernel.write.dims
            if len(w) == 1 and not w[0].setup and w[0].constant == 0 \
                    and len(w[0].factors) == 1 \
                    and next(iter(w[0].factors.values())) == 1:
                for op in kernel.reads:
                    if (
                        op.is_raw
                        and op.tensor != kernel.write.tensor
                        and len(op.dims) == 1
                        and not op.dims[0].setup
                        and op.dims[0].constant == 0
                        and op.dims[0].factors == w[0].factors
                    ):
                        src = op.tensor
                        break
        if src is not None:
            out.append(
                ShapeConstraint(
                    ShapeConstrKind.COPY,
                    dest=kernel.write.tensor,
                    src=src,
                )
            )
    else:
        linear = ShapeConstraint(ShapeConstrKind.LINEAR, dest=kernel.write.tensor)
        for op in kernel.reads:
            if not op.is_raw:
                per_dim = linear.reads.setdefault(
                    op.tensor, [[] for _ in op.dims]
                )
                if len(per_dim) == len(op.dims):
                    for it, dim in enumerate(op.dims):
                        per_dim[it].append(dim.copy())
        linear.write = [d.copy() for d in kernel.write.dims]
        for per_dim in linear.reads.values():
            for it in range(len(per_dim)):
                per_dim[it] = _simplify_max_index(per_dim[it])
        out.append(linear)

    for kind, op in kernel.tensor_ops():
        if not op.is_raw:
            out.append(
                ShapeConstraint(
                    ShapeConstrKind.RANK,
                    dest=op.tensor,
                    priority=ShapeConstrPriority.CONDITION,
                    rank=len(op.dims),
                )
            )
    return out


def infer_shape_constraints(program: Program) -> None:
    program.assert_pass(
        "infer_shape_constraints",
        requires={Stage.FOLDED, Stage.TENSOR_LOOKUPS},
        produces={Stage.SHAPES},
        preserves=ALL_STAGES,
    )
    for target in program.targets.values():
        for tid in program.caches:
            tensor = program.tensors[tid]
            assert tensor.cache_of is not None
            target.shapes.append(
                ShapeConstraint(
                    ShapeConstrKind.COPY, dest=tid, src=tensor.cache_of
                )
            )
        for kernel in target.kernels:
            # extern results are opaque: their shapes come from the user's
            # with_shape/copy_shape annotation (enforced by the sort pass)
            if kernel.generator.kind == ir.GenKind.NONE and kernel.extern is None:
                target.shapes.extend(_kernel_constraints(kernel))


def _is_underconstrained(constr: ShapeConstraint) -> bool:
    if constr.kind == ShapeConstrKind.NONE:
        return True
    if constr.kind == ShapeConstrKind.RANK:
        return constr.rank > 0
    if constr.kind in (ShapeConstrKind.DIMS, ShapeConstrKind.COPY):
        return False
    # LINEAR: every register in the write dims must appear in some read
    defined: set[int] = set()
    for per_dim in constr.reads.values():
        for indices in per_dim:
            for index in indices:
                defined.update(index.factors)
    for dim in constr.write:
        if any(r not in defined for r in dim.factors):
            return True
    return False


def sort_shape_constraints(program: Program) -> None:
    """Pick one constraint per tensor and order by dependency
    (reference passes.nim:1169-1221)."""
    program.assert_pass(
        "sort_shape_constraints",
        requires={Stage.SHAPES, Stage.COLLECTED},
        produces={Stage.SORTED_SHAPES},
        preserves=ALL_STAGES,
    )

    for target in program.targets.values():
        best: dict[int, ShapeConstraint] = {}
        conditions: list[ShapeConstraint] = []
        for constr in target.shapes:
            prev = best.get(constr.dest)
            if prev is None or prev.priority < constr.priority:
                best[constr.dest] = constr
            if constr.priority == ShapeConstrPriority.CONDITION:
                conditions.append(constr)

        # rank-condition checking (reference passes.nim:1190-1215)
        for cond in conditions:
            assert cond.kind == ShapeConstrKind.RANK
            constr = best.get(cond.dest)
            if constr is None:
                continue
            while (
                constr.kind == ShapeConstrKind.COPY
                and constr.src in best
                and not program.tensors[constr.dest].shape
            ):
                constr = best[constr.src]
            if (
                constr.kind == ShapeConstrKind.COPY
                and not program.tensors[constr.dest].shape
            ):
                best[constr.src] = cond
                continue
            static_shape = program.tensors[constr.dest].shape
            if static_shape:
                rank = len(static_shape)
            elif constr.kind == ShapeConstrKind.DIMS:
                rank = len(constr.dims)
            elif constr.kind == ShapeConstrKind.LINEAR:
                rank = len(constr.write)
            elif constr.kind == ShapeConstrKind.RANK:
                rank = constr.rank
            else:
                continue
            if cond.rank != rank:
                raise ShapeError(
                    f"a constraint requires tensor t{cond.dest} to have rank "
                    f"{cond.rank}, but it has rank {rank}"
                )

        order: list[ShapeConstraint] = []
        closed: set[int] = set()

        def flatten(tid: int) -> None:
            if program.tensors[tid].kind not in (
                ir.TensorKind.RESULT,
                ir.TensorKind.CACHE,
                ir.TensorKind.RANDOM,
            ) or tid in closed:
                return
            closed.add(tid)
            if tid not in best:
                name = program.tensors[tid].name
                raise ShapeError(
                    f"tensor t{tid}{f' ({name})' if name else ''} requires a shape"
                )
            constr = best[tid]
            if _is_underconstrained(constr):
                raise ShapeError(f"shape for tensor t{tid} is underconstrained")
            for dep in constr.deps():
                flatten(dep)
            order.append(constr)

        for tid in sorted(target.tensors):
            flatten(tid)
        target.shapes = order


# ---------------------------------------------------------------------------
# static (compile-time) shape inference
# ---------------------------------------------------------------------------

def static_shape_table(program: Program) -> dict[int, list[int]]:
    return {
        tid: list(t.shape)
        for tid, t in enumerate(program.tensors)
        if t.shape
    }


def _tname(names: Optional[dict[int, str]], tid: int) -> str:
    """``t3 ('weights')`` when the tensor has a user-visible name."""
    name = (names or {}).get(tid)
    return f"t{tid}" + (f" ({name!r})" if name else "")


def _apply_constraint(
    constr: ShapeConstraint,
    shapes: dict[int, list[int]],
    static: bool,
    names: Optional[dict[int, str]] = None,
) -> Optional[list[int]]:
    """Compute the shape for constr.dest given currently known shapes.

    ``static=True`` tolerates unknown (-1) dims; runtime mode raises.
    """
    kind = constr.kind
    if kind == ShapeConstrKind.NONE:
        return None
    if kind == ShapeConstrKind.RANK:
        return [0] * constr.rank if not static else [-1] * constr.rank
    if kind == ShapeConstrKind.COPY:
        assert constr.src is not None
        if constr.src in shapes:
            return list(shapes[constr.src])
        if static:
            return None
        raise ShapeError(
            f"shape of tensor {_tname(names, constr.src)} is unknown; "
            "maybe you forgot to pass a required input tensor?"
        )
    if kind == ShapeConstrKind.DIMS:
        sizes = []
        for index in constr.dims:
            value = eval_linear(index, shapes)
            if value is None:
                if static:
                    sizes.append(-1)
                    continue
                raise ShapeError(
                    "not all shapes are known; "
                    "maybe you forgot to pass a required input tensor?"
                )
            sizes.append(value)
        return sizes
    # LINEAR: solve index == size-1 per known read dim
    equations: list[LinearIndex] = []
    for tensor, per_dim in constr.reads.items():
        if tensor not in shapes:
            if static:
                continue
            raise ShapeError(
                f"shape of tensor {_tname(names, tensor)} is unknown, but "
                f"required to infer the shape of "
                f"{_tname(names, constr.dest)}; maybe you forgot to pass a "
                "required input tensor?"
            )
        shape = shapes[tensor]
        if len(shape) != len(per_dim):
            if static:
                continue
            raise ShapeError(
                f"tensor {_tname(names, tensor)} has rank {len(shape)}, but "
                f"is accessed with {len(per_dim)} indices"
            )
        for dim, indices in enumerate(per_dim):
            size = shape[dim]
            if size < 0:
                continue
            for index in indices:
                equations.append(index - LinearIndex.of_const(size - 1))

    try:
        solution = solve_partial(equations)
        max_values = {r: int(v) for r, v in solution.items()}
    except ShapeError as err:
        # the exact system (max index == size-1 per read, reference
        # passes.nim:1252) is inconsistent; retry with floor-bound
        # semantics for strided reads before giving up
        floored = solve_floor(equations)
        if floored is None:
            # name the tensor and the read extents so the user can see
            # WHICH kernel's reads disagree
            reads_desc = ", ".join(
                f"{_tname(names, tensor)}{[shapes[tensor]] if tensor in shapes else ''}"
                for tensor in constr.reads
            )
            raise ShapeError(
                f"{err} while inferring the shape of "
                f"{_tname(names, constr.dest)} from its reads of {reads_desc}; "
                "unit-stride read indices must span each tensor dim exactly "
                "(max index == size-1) and strided reads to within one "
                "stride — resize the operand or bound the iterator (irange)"
            ) from err
        max_values = floored
    sizes = []
    for index in constr.write:
        if any(r not in max_values for r in index.factors) or index.setup:
            if static:
                sizes.append(-1)
                continue
            raise ShapeError(
                f"shape of tensor {_tname(names, constr.dest)} is "
                "underconstrained: the loop ranges of its kernel cannot all "
                "be solved from the read tensors' shapes; bound the "
                "iterators (irange) or declare the shape (with_shape)"
            )
        sizes.append(index.eval(max_values) + 1)
    return sizes


def infer_static_shapes(program: Program) -> None:
    program.assert_pass(
        "infer_static_shapes",
        requires={Stage.SORTED_SHAPES},
        produces={Stage.STATIC_SHAPES},
        preserves=ALL_STAGES,
    )
    shapes = static_shape_table(program)
    names = {t: d.name for t, d in enumerate(program.tensors) if d.name}
    for target in program.targets.values():
        for constr in target.shapes:
            dims = _apply_constraint(constr, shapes, static=True, names=names)
            if dims is None or not dims:
                continue
            if constr.dest in shapes:
                prev = shapes[constr.dest]
                if len(prev) == len(dims):
                    merged = []
                    for a, b in zip(prev, dims):
                        if a >= 0 and b >= 0 and a != b:
                            raise ShapeError(
                                f"conflicting static shapes for tensor "
                                f"t{constr.dest}: {prev} vs {dims}"
                            )
                        merged.append(a if a >= 0 else b)
                    shapes[constr.dest] = merged
                elif all(d < 0 for d in dims):
                    pass
                else:
                    raise ShapeError(
                        f"conflicting static ranks for tensor t{constr.dest}: "
                        f"{prev} vs {dims}"
                    )
            elif any(d >= 0 for d in dims):
                shapes[constr.dest] = dims

    for tid, tensor in enumerate(program.tensors):
        if tensor.kind in (ir.TensorKind.RESULT, ir.TensorKind.RANDOM):
            if tid in shapes:
                tensor.shape = list(shapes[tid])
        elif tensor.kind == ir.TensorKind.CACHE:
            if tid not in shapes or any(s < 0 for s in shapes[tid]):
                raise ShapeError(
                    f"shape of cache {tensor.name!r} must be inferred at "
                    "compile time"
                )
            tensor.shape = list(shapes[tid])


# ---------------------------------------------------------------------------
# runtime shape inference
# ---------------------------------------------------------------------------

def infer_shapes(
    program: Program,
    target_name: str,
    inputs: Sequence[tuple[int, list[int]]],
) -> dict[int, list[int]]:
    """Infer shapes of all target tensors from input shapes
    (reference inferShapes, passes.nim:1386-1436)."""
    shapes: dict[int, list[int]] = {}
    names = {t: d.name for t, d in enumerate(program.tensors) if d.name}
    for tid, shape in inputs:
        static = program.tensors[tid].shape
        if static and (
            len(static) != len(shape)
            or any(s >= 0 and s != d for s, d in zip(static, shape))
        ):
            raise ShapeError(
                f"given shape for tensor {_tname(names, tid)} is "
                f"{list(shape)}, but its static shape is {static}"
            )
        shapes[tid] = list(shape)
    for tid in program.params:
        shapes[tid] = list(program.tensors[tid].shape)

    for constr in program.targets[target_name].shapes:
        for dep in constr.deps():
            if dep not in shapes:
                tdef = program.tensors[dep]
                name = f' "{tdef.name}"' if tdef.name else ""
                raise ShapeError(
                    f"missing shape for tensor{name} (t{dep}); "
                    "maybe you forgot to pass an input to the model?"
                )
        dims = _apply_constraint(constr, shapes, static=False, names=names)
        if dims is not None:
            shapes[constr.dest] = dims
    _check_raw_extents(program, target_name, shapes, names)
    return shapes


def _flat(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _identity_iter(op) -> Optional[int]:
    """The register when a raw access is exactly ``{it}``, else None."""
    if not op.is_raw or len(op.dims) != 1:
        return None
    d = op.dims[0]
    if d.setup or d.constant != 0 or len(d.factors) != 1:
        return None
    reg, coeff = next(iter(d.factors.items()))
    return reg if coeff == 1 else None

def _check_raw_extents(
    program: Program,
    target_name: str,
    shapes: dict[int, list[int]],
    names: Optional[dict[int, str]] = None,
) -> None:
    """Identity-indexed raw reads must cover the write's flat extent.

    The write tensor's flat size IS the loop extent for its identity
    iterator; a same-iterator read of a smaller tensor would read out of
    bounds (the numpy oracle raises IndexError, the XLA backend silently
    clamps the gather) — catch it as a ShapeError up front.
    """
    for kernel in program.targets[target_name].kernels:
        if kernel.write is None:
            continue
        wreg = _identity_iter(kernel.write)
        if wreg is None or kernel.write.tensor not in shapes:
            continue
        extent = _flat(shapes[kernel.write.tensor])
        for op in kernel.reads:
            if (
                _identity_iter(op) == wreg
                and op.tensor in shapes
                and _flat(shapes[op.tensor]) < extent
            ):
                raise ShapeError(
                    f"tensor {_tname(names, op.tensor)} has "
                    f"{_flat(shapes[op.tensor])} elements but is read "
                    f"elementwise against {_tname(names, kernel.write.tensor)} "
                    f"with {extent} elements"
                )
