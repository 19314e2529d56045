"""Generated map/reduce kernels (kernel B5): IR -> Triton source, the
plain version, the wrapper and its launch count.

Counterpart of ``PallasMapReduce.lower`` in
``exprgrad_tpu/backend/pallasgen.py``.  The TPU package traces one Pallas
kernel per scheduled IR kernel; the port emits one ``@triton.jit`` source
per kernel, once per executor, from the plan of
:class:`~exprgrad_torch.backend.mapreduce.ScheduledMapReduce`:

* each program owns ``BLOCK_P`` positions of the program axes P (the
  write's axes, flattened with the innermost loop axis fastest) and
  recovers each iterator with ``//`` and ``%`` by literal extents;
* it loops over the reduced axes Q in blocks of ``BLOCK_Q`` with a float32
  accumulator that starts at the accumulation identity, so a reduction
  over any extent runs inside one program, in one order, and gives the
  same bits on every run;
* every read is a load from the address its IR index computes: shifts,
  strides, ``i // k`` groups, flat ``{i}`` reads and computed (gathered)
  indices alike; a computed index outside ``[0, V)`` reads 0, as the TPU
  kernel's compare-select does, and never touches foreign memory;
* dynamic bounds and ragged edges are masks to the identity;
* a plain write stores ``prev (+|max|min) value`` into a fresh tensor;
* a scatter is owner-computes over destination segments
  (:func:`emit_scatter`): a generated kernel writes each position's
  destination row, a stable sort of those keys groups the positions by
  it (:func:`group`), then each program owns one row and
  a block of its columns, walks the row's positions in position order and
  writes each element once.  No float atomics: every kernel gives the
  same bits on every run.

bfloat16 operands are loaded, computed in float32 and stored once.
:func:`mapreduce_impl` launches the kernel for CUDA tensors and raises on
any other device but the CPU, where it runs the plain version: the
port's own lowering of the same IR kernel (whole-tensor einsum and gather
code), which shares nothing with the emitter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..interp import accumulation_identity
from ..ir import Op
from ..utils import triton_build

# kernel launches since the last reset; chip_smoke.py reads it to prove
# the main path ran through the kernel
launches = 0

_TL_DTYPE = {torch.float32: "tl.float32", torch.bfloat16: "tl.bfloat16"}
_COMBINE = {"add": "{a} + {b}", "max": "tl.maximum({a}, {b})",
            "min": "tl.minimum({a}, {b})"}
_REDUCE = {"add": "tl.sum", "max": "tl.max", "min": "tl.min"}
_UNARY = {Op.SIN: "libdevice.sin", Op.COS: "libdevice.cos",
          Op.EXP: "libdevice.exp", Op.LN: "libdevice.log",
          Op.LOG2: "libdevice.log2", Op.LOG10: "libdevice.log10",
          Op.SQRT: "tl.sqrt_rn"}
_INT32_LIMIT = 2 ** 31 - 1
HEADER = (
    "import triton\n"
    "import triton.language as tl\n"
    "from triton.language.extra import libdevice\n"
)


def pow2(n: int) -> int:
    """The least power of two >= n (and >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def contiguous_strides(shape) -> list[int]:
    strides, s = [], 1
    for extent in reversed(shape):
        strides.append(s)
        s *= int(extent)
    return strides[::-1]


def lit(value) -> str:
    """A Python literal the Triton front end reads as the same constant."""
    if isinstance(value, (bool, np.bool_)):
        return "True" if value else "False"
    if isinstance(value, (int, np.integer)):
        return f"({int(value)})" if value < 0 else str(int(value))
    value = float(value)
    if math.isnan(value):
        return 'float("nan")'
    if math.isinf(value):
        return '(-float("inf"))' if value < 0 else 'float("inf")'
    text = repr(value)
    return f"({text})" if value < 0 else text


def identity_lit(mode: str) -> str:
    return lit(accumulation_identity(mode))


class Val:
    """An emitted value: a Triton expression (or a Python constant), its
    kind ("f" float32, "i" index, "b" bool) and the loop axes it varies
    over, which fix its block shape."""

    __slots__ = ("code", "kind", "axes")

    def __init__(self, code, kind: str, axes=frozenset()):
        self.code = code
        self.kind = kind
        self.axes = frozenset(axes)

    @property
    def const(self) -> bool:
        return not isinstance(self.code, str)

    def text(self) -> str:
        return lit(self.code) if self.const else self.code

    def f32(self) -> str:
        if self.const:
            return lit(float(self.code))
        return self.code if self.kind == "f" else f"{self.code}.to(tl.float32)"


def _ieee(op, args):
    """The IEEE float32 value of an op on constants whose exact static
    evaluation faulted (1.0 / 0.0 is inf, as the kernel computes it)."""
    x = [np.float32(float(a)) for a in args]
    with np.errstate(all="ignore"):
        table = {
            Op.DIV: lambda: x[0] / x[1],
            Op.SQRT: lambda: np.sqrt(x[0]),
            Op.LN: lambda: np.log(x[0]),
            Op.LOG2: lambda: np.log2(x[0]),
            Op.LOG10: lambda: np.log10(x[0]),
            Op.LOG: lambda: np.log(x[0]) / np.log(x[1]),
            Op.POW: lambda: np.power(x[0], x[1]),
            Op.EXP: lambda: np.exp(x[0]),
        }
        fn = table.get(op)
        return None if fn is None else float(fn())


class Emitter:
    """Straight-line Triton code for IR instructions, reads and indices.

    ``p_axes`` and ``q_axes`` name the loop axes whose iterators are the
    rows ([BLOCK_P, 1]) and the columns ([1, BLOCK_Q]) of a program's
    block; with no ``q_axes`` the block is 1-D over P.  Loads are shared
    between the kernels of one emitter (a row chain reads its block once)
    by the tensor and the loop axes their indices name."""

    def __init__(self, shapes, p_axes, q_axes, itype: str, indent: str,
                 bp: int, bq: int = 1):
        self.shapes = shapes
        self.bp, self.bq = bp, bq
        self.p = list(p_axes)
        self.q = list(q_axes)
        self.two_d = bool(self.q)
        self.itype = itype
        self.indent = indent
        self.lines: list[str] = []
        self.n = 0
        self.args: list[int] = []  # tensor ids, in argument order
        self.loads: dict = {}

    # -- plumbing ------------------------------------------------------
    def line(self, text: str) -> None:
        self.lines.append(self.indent + text)

    def tmp(self, code: str, kind: str, axes) -> Val:
        name = f"t{self.n}"
        self.n += 1
        self.line(f"{name} = {code}")
        return Val(name, kind, axes)

    def ptr(self, tid: int) -> str:
        if tid not in self.args:
            self.args.append(tid)
        return f"x{self.args.index(tid)}_ptr"

    def iterator(self, axis: int) -> Val:
        if not self.two_d:
            return Val(f"p{axis}", "i", {axis})
        if axis in self.q:
            return Val(f"Q{axis}", "i", {axis})
        return Val(f"P{axis}", "i", {axis})

    def element_mask(self, axes) -> list[str]:
        """The in-range masks of the block rows/columns ``axes`` span."""
        axes = set(axes)
        if not self.two_d:
            return ["p_ok"] if axes else []
        out = []
        if axes & set(self.p):
            out.append("P_ok")
        if axes & set(self.q):
            out.append("Q_ok")
        return out

    def block_shape(self, axes) -> str:
        axes = set(axes)
        if not self.two_d:
            return f"[{self.bp}]"
        rows = self.bp if axes & set(self.p) else 1
        cols = self.bq if axes & set(self.q) else 1
        return f"[{rows}, {cols}]"

    def broadcast(self, val: Val, axes) -> str:
        """``val`` as a float32 block over ``axes`` (which hold its own)."""
        if set(val.axes) == set(axes) and not val.const:
            return val.f32()
        zeros = f"tl.zeros({self.block_shape(axes)}, tl.float32)"
        return f"({zeros} + {val.f32()})"


class Scope:
    """The registers of one IR kernel inside an emitter: its iterators,
    static setup values, the epoch, its reads (loaded when first used)
    and the instructions of its expression and indices."""

    def __init__(self, em: Emitter, kernel, low, static: dict,
                 epoch_regs=(), locals_=None, gathers=None):
        self.em = em
        self.kernel = kernel
        self.low = low
        self.env: dict[int, Val] = {}
        for reg, axis in low.axis_of_reg.items():
            self.env[reg] = em.iterator(axis)
        for reg, value in static.items():
            self.env[reg] = Val(value, "f" if isinstance(value, float)
                                else "b" if isinstance(value, bool) else "i")
        for reg in epoch_regs:
            self.env[reg] = Val("epoch", "i")
        self.reads = {r.data: r for r in kernel.reads}
        # read data reg -> value computed earlier in the same program
        self.locals = locals_ or {}
        # read data reg -> its computed dims (ScheduledMapReduce.gather_reads)
        self.gathers = gathers or {}
        self.defs = {}
        for instr in list(kernel.setup) + list(kernel.expr.instrs):
            if instr.res is not None:
                self.defs[instr.res] = instr

    def val(self, reg: int) -> Val:
        got = self.env.get(reg)
        if got is not None:
            return got
        if reg in self.locals:
            got = self.locals[reg]
        elif reg in self.reads:
            got = self.load(self.reads[reg])
        elif reg in self.defs:
            got = self.instr(self.defs[reg])
        else:
            raise KeyError(f"register r{reg} has no value in the kernel")
        self.env[reg] = got
        return got

    def run(self, instrs) -> None:
        for instr in instrs:
            if instr.res is not None and instr.res not in self.env:
                self.env[instr.res] = self.instr(instr)

    # -- instructions --------------------------------------------------
    def instr(self, instr) -> Val:
        from ..backend.mapreduce import NOT_STATIC, eval_static_instr

        op = instr.op
        if op == Op.EPOCH:
            return Val("epoch", "i")
        a = [self.val(r) for r in instr.args]
        if all(x.const for x in a):
            static = {r: x.code for r, x in zip(instr.args, a)}
            value = eval_static_instr(instr, static, self.low.shapes)
            if value is NOT_STATIC and a:
                value = _ieee(op, [x.code for x in a])
                value = NOT_STATIC if value is None else value
            if value is not NOT_STATIC:
                kind = ("b" if isinstance(value, bool) else
                        "i" if isinstance(value, (int, np.integer))
                        else "f")
                return Val(value, kind)
        axes = frozenset().union(*(x.axes for x in a)) if a else frozenset()
        em = self.em
        if op in (Op.ADD, Op.SUB, Op.MUL):
            sym = {Op.ADD: "+", Op.SUB: "-", Op.MUL: "*"}[op]
            kind = "f" if any(x.kind == "f" for x in a) else "i"
            return em.tmp(f"{a[0].text()} {sym} {a[1].text()}", kind, axes)
        if op == Op.DIV:
            return em.tmp(f"tl.div_rn({a[0].f32()}, {a[1].f32()})", "f",
                          axes)
        if op in (Op.IDX_DIV, Op.MOD):
            # Triton's integer // and % truncate toward zero, as the IR's
            sym = "//" if op == Op.IDX_DIV else "%"
            kind = "f" if any(x.kind == "f" for x in a) else "i"
            return em.tmp(f"{a[0].text()} {sym} {a[1].text()}", kind, axes)
        if op == Op.WRAP:
            x, m = a[0].text(), a[1].text()
            return em.tmp(f"(({x} % {m}) + {m}) % {m}", a[0].kind, axes)
        if op == Op.NEG:
            if a[0].kind == "b":
                return em.tmp(f"{a[0].text()} == 0", "b", axes)
            return em.tmp(f"-{a[0].text()}", a[0].kind, axes)
        if op in _UNARY:
            return em.tmp(f"{_UNARY[op]}({a[0].f32()})", "f", axes)
        if op == Op.POW:
            return em.tmp(f"libdevice.pow({a[0].f32()}, {a[1].f32()})", "f",
                          axes)
        if op == Op.LOG:
            return em.tmp(f"tl.div_rn(libdevice.log({a[0].f32()}), "
                          f"libdevice.log({a[1].f32()}))", "f", axes)
        if op in (Op.EQ, Op.LT, Op.LE):
            sym = {Op.EQ: "==", Op.LT: "<", Op.LE: "<="}[op]
            return em.tmp(f"{a[0].text()} {sym} {a[1].text()}", "b", axes)
        if op in (Op.AND, Op.OR):
            for x, y in ((a[0], a[1]), (a[1], a[0])):
                if x.const:
                    keep = bool(x.code) == (op == Op.AND)
                    return y if keep else Val(bool(x.code), "b")
            sym = "&" if op == Op.AND else "|"
            return em.tmp(f"{a[0].text()} {sym} {a[1].text()}", "b", axes)
        if op == Op.SELECT:
            if a[0].const:
                return a[1] if a[0].code else a[2]
            kind = "f" if "f" in (a[1].kind, a[2].kind) else a[1].kind
            t = a[1].f32() if kind == "f" else a[1].text()
            e = a[2].f32() if kind == "f" else a[2].text()
            return em.tmp(f"tl.where({a[0].text()}, {t}, {e})", kind, axes)
        if op == Op.TO_SCALAR:
            return em.tmp(a[0].f32(), "f", axes) if not a[0].const else \
                Val(float(a[0].code), "f")
        if op == Op.TO_INDEX:
            return em.tmp(f"{a[0].text()}.to({em.itype})", "i", axes)
        raise ValueError(f"op {op.value} has no Triton form")

    def index(self, index) -> Val:
        """A LinearIndex (setup instructions, factors, constant)."""
        self.run(index.setup)
        const = int(index.constant)
        terms, axes = [], set()
        for reg, factor in index.factors.items():
            v = self.val(reg)
            if v.const:
                const += int(v.code) * factor
                continue
            terms.append(v.code if factor == 1
                         else f"{v.code} * {lit(factor)}")
            axes |= v.axes
        if not terms:
            return Val(const, "i")
        if len(terms) == 1 and not const and len(index.factors) == 1 \
                and next(iter(index.factors.values())) == 1:
            return self.val(next(iter(index.factors)))
        if const:
            terms.append(lit(const))
        return self.em.tmp(" + ".join(terms), "i", axes)

    # -- reads ---------------------------------------------------------
    def _dim_key(self, index):
        if index.setup:
            return None
        key = []
        for reg, factor in sorted(index.factors.items()):
            axis = self.low.axis_of_reg.get(reg)
            if axis is None:
                return None
            key.append((axis, factor))
        return (index.constant, tuple(key))

    def load(self, read) -> Val:
        em = self.em
        keys = [self._dim_key(d) for d in read.dims]
        key = None
        if all(k is not None for k in keys):
            key = (read.tensor, read.is_raw, tuple(keys))
            if key in em.loads:
                return em.loads[key]
        shape = self.low.shapes[read.tensor]
        guards: list[Val] = []
        terms: list[Val] = []
        gather = self.gathers.get(read.data)
        if read.is_raw:
            total = int(np.prod(shape, dtype=np.int64))
            flat = self.index(read.dims[0])
            guards.append(self._in_range(flat, total, read.dims[0], total))
            terms.append(flat)
        else:
            strides = contiguous_strides(shape)
            computed = set(gather["dims"]) if gather else set()
            if gather:
                flat = self._flat(read.dims, gather)
                guards.append(self._in_range(flat, gather["V"], None,
                                             gather["V"]))
            for d, index in enumerate(read.dims):
                if d in computed:
                    idx = self._unravel(flat, gather, d, shape)
                else:
                    idx = self.index(index)
                    guards.append(self._in_range(idx, shape[d], index,
                                                 shape[d]))
                terms.append(self._scaled(idx, strides[d]))
        addr = self._sum(terms)
        ok = [g for g in guards if g is not True]
        if any(g is False for g in ok):
            got = Val(0.0, "f")
        elif addr.const:
            got = em.tmp(f"tl.load({em.ptr(read.tensor)} + {addr.text()})"
                         ".to(tl.float32)", "f", ())
        else:
            masks = [g.code for g in ok] + em.element_mask(addr.axes)
            mask = " & ".join(masks) if masks else None
            got = em.tmp(
                f"tl.load({em.ptr(read.tensor)} + {addr.code}"
                + (f", mask={mask}, other=0.0" if mask else "")
                + ").to(tl.float32)", "f", addr.axes)
        if key is not None:
            em.loads[key] = got
        return got

    def _flat(self, dims, gather) -> Val:
        terms = [self._scaled(self.index(dims[d]), gather["strides"][d])
                 for d in gather["dims"]]
        return self._sum(terms)

    def _unravel(self, flat: Val, gather, d: int, shape) -> Val:
        stride = gather["strides"][d]
        first = d == gather["dims"][0]
        if flat.const:
            value = flat.code // stride
            return Val(value if first else value % int(shape[d]), "i")
        code = flat.code if stride == 1 else f"{flat.code} // {stride}"
        if not first:
            code = f"({code}) % {int(shape[d])}"
        if code == flat.code:
            return flat
        return self.em.tmp(code, "i", flat.axes)

    def _in_range(self, idx: Val, extent: int, index, total):
        """True, False or a bool Val: 0 <= idx < extent.  A plain
        iterator over the whole extent needs no guard."""
        if idx.const:
            return 0 <= idx.code < extent
        if index is not None:
            axis = self.low._pure_iter(index)
            if axis is not None and self.low._full_axis(axis, total):
                return True
        return self.em.tmp(f"({idx.code} >= 0) & ({idx.code} < {extent})",
                           "b", idx.axes)

    def _scaled(self, idx: Val, stride: int) -> Val:
        if idx.const:
            return Val(idx.code * stride, "i")
        if stride == 1:
            return idx
        return Val(f"{idx.code} * {stride}", "i", idx.axes)

    def _sum(self, terms) -> Val:
        const, parts, axes = 0, [], set()
        for t in terms:
            if t.const:
                const += int(t.code)
            else:
                parts.append(t.code)
                axes |= t.axes
        if not parts:
            return Val(const, "i")
        if len(parts) == 1 and not const:
            got = next(t for t in terms if not t.const)
            if got.code.isidentifier():
                return got
        if const:
            parts.append(lit(const))
        return self.em.tmp(" + ".join(parts), "i", axes)

    def bounds_mask(self, dyn_bounds) -> list[str]:
        """The hull masks of dynamic bounds: lo <= i < hi per point."""
        out = []
        for axis, (lo_c, lo_t), (hi_c, hi_t) in dyn_bounds:
            it = self.em.iterator(axis).code

            def affine(c, terms):
                parts = [lit(c)] + [
                    f"{self.em.iterator(dep).code} * {lit(f)}"
                    for dep, f in terms]
                return "(" + " + ".join(parts) + ")"

            out.append(self.em.tmp(
                f"({it} >= {affine(lo_c, lo_t)}) & "
                f"({it} < {affine(hi_c, hi_t)})", "b", ()).code)
        return out


def iterators(em: Emitter, axes, sizes, src: str, name: str) -> None:
    """Recover each axis's iterator from the flat position ``src``
    (innermost axis fastest)."""
    rest = src
    inner = list(reversed(axes))
    for k, axis in enumerate(inner):
        if k == len(inner) - 1:
            if k == 0:
                em.line(f"{name}{axis} = {rest}")
            break
        size = int(sizes[axis])
        em.line(f"{name}{axis} = {rest} % {size}")
        if k == len(inner) - 2:
            em.line(f"{name}{inner[k + 1]} = {rest} // {size}")
        else:
            em.line(f"{name}_{axis} = {rest} // {size}")
            rest = f"{name}_{axis}"


def index_type(sizes, shapes) -> str:
    """int32 unless a position or an address can pass 2^31 - 1."""
    biggest = max([int(np.prod(sizes, dtype=np.int64))]
                  + [int(np.prod(s, dtype=np.int64)) for s in shapes])
    return "tl.int64" if biggest > _INT32_LIMIT else "tl.int32"


def program_ids(em: Emitter, block: int, count: int, itype: str) -> None:
    pid = "tl.program_id(0)"
    rng = f"tl.arange(0, {block})"
    if itype == "tl.int64":
        pid, rng = f"{pid}.to(tl.int64)", f"{rng}.to(tl.int64)"
    em.line(f"p = {pid} * {block} + {rng}")
    em.line(f"p_ok = p < {count}")


def plan_blocks(n_p: int, n_q: int) -> tuple[int, int, int]:
    """(BLOCK_P, BLOCK_Q, num_warps) of a map/reduce kernel: a block of
    about 4096 elements, as wide in Q as the reduction allows up to 1024
    (``n_q`` is 0 when the kernel reduces nothing in the program)."""
    if n_q:
        bq = min(pow2(n_q), 1024)
        bp = min(pow2(n_p), max(1, 4096 // bq))
    else:
        bq, bp = 0, min(pow2(n_p), 1024)
    warps = 8 if bp * max(bq, 1) >= 4096 else 4
    return bp, bq, warps


def emit_mapreduce(mr) -> tuple[str, list[int], dict]:
    """The Triton source of one classified map/reduce kernel:
    ``(source, operand tensor ids, launch plan)``."""
    if mr.scatter is not None:
        return emit_scatter(mr)
    low = mr.low
    kernel = mr.kernel
    write = kernel.write
    mode = write.accumulate
    sizes = low.sizes
    p_axes, q_axes = mr.p_axes, mr.q_axes
    n_p = int(np.prod([sizes[a] for a in p_axes], dtype=np.int64))
    n_q = int(np.prod([sizes[a] for a in q_axes], dtype=np.int64))
    bp, bq, warps = plan_blocks(n_p, n_q if q_axes else 0)
    itype = index_type(sizes, low.shapes.values())
    ident = identity_lit(mode)

    em = Emitter(low.shapes, p_axes, q_axes, itype, " " * 4, bp, bq)
    program_ids(em, bp, n_p, itype)
    iterators(em, p_axes, sizes, "p", "p")
    scope = Scope(em, kernel, low, mr.setup_env, mr.epoch_regs,
                  gathers=mr.gather_reads)
    if q_axes:
        em.line(f"acc = tl.full([{bp}], {ident}, tl.float32)")
        em.line("P_ok = p_ok[:, None]")
        for a in p_axes:
            em.line(f"P{a} = p{a}[:, None]")
        em.line(f"for q_start in range(0, {n_q}, {bq}):")
        em.indent = " " * 8
        q_range = f"tl.arange(0, {bq})"
        if itype == "tl.int64":
            q_range += ".to(tl.int64)"
        em.line(f"q = q_start + {q_range}")
        em.line(f"q_ok = q < {n_q}")
        iterators(em, q_axes, sizes, "q", "q")
        em.line("Q_ok = q_ok[None, :]")
        for a in q_axes:
            em.line(f"Q{a} = q{a}[None, :]")
    scope.run(kernel.setup)
    value = scope.val(kernel.expr.res)
    masks = scope.bounds_mask(mr.dyn_bounds)
    if q_axes:
        valid = " & ".join(["P_ok", "Q_ok"] + masks)
        em.line(f"v = tl.where({valid}, {value.f32()}, {ident})")
        reduced = f"{_REDUCE[mode]}(v, axis=1)"
        em.line(f"acc = {_COMBINE[mode].format(a='acc', b=reduced)}")
        em.indent = " " * 4
    else:
        v = em.broadcast(value, p_axes) if p_axes else \
            f"(tl.zeros([{bp}], tl.float32) + {value.f32()})"
        if masks:
            v = f"tl.where({' & '.join(masks)}, {v}, {ident})"
        em.line(f"acc = {v}")
    if mr.phantom != 1 and mode == "add":
        em.line(f"acc = acc * {lit(float(mr.phantom))}")

    out_shape = low.shapes[write.tensor]
    strides = contiguous_strides(
        [int(np.prod(out_shape, dtype=np.int64))] if write.is_raw
        else out_shape)
    terms = []
    for d, index in enumerate(write.dims):
        axis = low._pure_iter(index)
        if axis is None:
            continue  # constant-0 dim of extent 1
        terms.append(f"p{axis} * {strides[d]}" if strides[d] != 1
                     else f"p{axis}")
    if not terms:
        terms = [f"tl.zeros([{bp}], {itype})"]
    em.line(f"o = {' + '.join(terms)}")
    args = _store(em, low, mode, "p_ok")
    args += "".join(f", x{k}_ptr" for k in range(len(em.args))) + ", epoch"

    nbytes = _bytes(low, kernel, low.fresh_output)
    design = (
        f"each program owns {bp} of {n_p} write positions"
        + (f" and loops over {n_q} reduced positions {bq} at a time, "
           "accumulating in float32 registers" if q_axes else "")
        + "; every operand element is read once and each output element "
        "written once"
    )
    source = _source(nbytes, design, [("egt_mapreduce", args, em.lines)])
    plan = {"grid": (n_p + bp - 1) // bp, "num_warps": warps,
            "block_p": bp, "block_q": bq, "bytes": nbytes}
    return source, list(em.args), plan


def _store(em: Emitter, low, mode: str, mask) -> str:
    """Store ``acc`` (combined with ``prev`` unless the output is fresh)
    at ``o``, rounded once, under ``mask`` (None: every lane); returns the
    output arguments."""
    out_dt = _TL_DTYPE[low.dtype]
    masked = f", mask={mask}" if mask else ""
    if low.fresh_output:
        em.line(f"tl.store(out_ptr + o, acc.to({out_dt}){masked})")
        return "out_ptr"
    em.line(f"prev = tl.load(prev_ptr + o{masked}"
            + (", other=0.0" if mask else "") + ").to(tl.float32)")
    em.line(f"tl.store(out_ptr + o, "
            f"({_COMBINE[mode].format(a='prev', b='acc')})"
            f".to({out_dt}){masked})")
    return "out_ptr, prev_ptr"


def _source(nbytes: int, design: str, functions) -> str:
    """A generated module: its header, then each ``(name, arguments,
    body lines)`` as a ``@triton.jit`` function (each string as it is)."""
    defs = "\n".join(
        fn if isinstance(fn, str) else
        ('@triton.jit(do_not_specialize=["epoch"])\n' if "epoch" in fn[1]
         else "@triton.jit\n")
        + f"def {fn[0]}({fn[1]}):\n" + "\n".join(fn[2]) + "\n"
        for fn in functions)
    return (
        "# Generated by exprgrad_torch.ops.mapreduce: kernel B5, the "
        "port of\n# exprgrad_tpu/backend/pallasgen.py:1804 "
        "PallasMapReduce.lower.\n"
        f"# Bound: bytes; {nbytes} bytes read and written, "
        f"{nbytes / 3.35e12 * 1e3:.6f} ms at 3.35 TB/s.\n"
        f"# Design: {design}.\n"
        + HEADER + "\n\n" + defs
    )


def plan_segments(n_pos: int, n_c: int, K: int) -> tuple[int, int, int]:
    """(BLOCK_S, BLOCK_C, num_warps) of a scatter's reduction: up to 128
    columns a program (more where the column blocks would pass the grid's
    second axis, 65535), and the mean segment length rounded up to a power
    of two positions at a time, at most 4096 elements a block (``n_c`` is
    0 when the write has no column axes)."""
    bc = min(pow2(n_c), 128) if n_c else 1
    while n_c and -(-n_c // bc) > 65535:
        bc *= 2
    mean = -(-n_pos // max(K, 1))
    bs = max(1, min(pow2(mean), 4096 // bc))
    return bs, bc, max(1, min(4, bs * bc // 256))


_TL_INT = {torch.int16: "tl.int16", torch.int32: "tl.int32",
           torch.int64: "tl.int64"}


def key_dtype(K: int) -> torch.dtype:
    """The narrowest integer that holds a scatter's keys [0, K] and K + 1
    (the radix sort then passes over half the bits of int32 keys)."""
    if K + 1 <= torch.iinfo(torch.int16).max:
        return torch.int16
    return torch.int32 if K + 1 <= _INT32_LIMIT else torch.int64


# a program walks at most this many blocks of a segment: a longer segment
# is cut where the sorted positions cross a multiple of SPLIT_BLOCKS *
# BLOCK_S, the pieces past the first are summed by programs of their own,
# and the pieces are added in order (emit_scatter)
SPLIT_BLOCKS = 16


def emit_scatter(mr) -> tuple[str, list[int], dict]:
    """The Triton source of one scatter: owner-computes over destination
    segments.  ``egt_scatter_keys`` writes each position's destination
    row (``K`` where the target is out of range, which drops it), and
    :func:`group` sorts the keys, stably, and finds each row's segment of
    the sorted positions.  Each program of ``egt_mapreduce`` then owns
    one destination row and a block of its columns, walks the row's
    positions in position order, evaluates the value there and writes
    every owned element once.  The sorted positions are cut in chunks of
    ``L``: a segment that crosses into chunk ``e`` has that piece summed
    by program ``K + e`` of the same grid, and the last of the segment's
    pieces to finish adds them in chunk order, so no program walks more
    than ``L`` positions and no program waits.  Returns ``(source,
    operand tensor ids, launch plan)``."""
    low, kernel = mr.low, mr.kernel
    write = kernel.write
    mode = write.accumulate
    sizes = low.sizes
    sc = mr.scatter
    seg, cols = sc["seg_axes"], sc["col_axes"]
    n_pos = int(np.prod([sizes[a] for a in seg], dtype=np.int64))
    n_c = int(np.prod([sizes[a] for a in cols], dtype=np.int64))
    K = int(sc["K"])
    itype = index_type(sizes, low.shapes.values())
    bs, bc, warps = plan_segments(n_pos, n_c if cols else 0, K)
    L = SPLIT_BLOCKS * bs
    kb = min(pow2(n_pos), 1024)
    kdt = key_dtype(K)
    ident = identity_lit(mode)
    out_shape = low.shapes[write.tensor]
    strides = contiguous_strides(out_shape)
    args: list[int] = []  # every function takes every operand, in one order

    # the keys: the flat row over the keyed dims of each position's target
    ek = Emitter(low.shapes, seg, [], itype, " " * 4, kb)
    ek.args = args
    program_ids(ek, kb, n_pos, itype)
    iterators(ek, seg, sizes, "p", "p")
    scope = Scope(ek, kernel, low, mr.setup_env, mr.epoch_regs,
                  gathers=mr.gather_reads)
    flat = scope._flat(write.dims, sc)
    terms = []
    for d in sc["keyed"]:
        idx = (scope._unravel(flat, sc, d, out_shape) if d in sc["dims"]
               else scope.index(write.dims[d]))
        terms.append(scope._scaled(idx, sc["kstrides"][d]))
    key = scope._sum(terms).text()
    if flat.const:
        key = key if 0 <= flat.code < sc["V"] else lit(K)
    else:
        key = (f"tl.where(({flat.code} >= 0) & ({flat.code} < {sc['V']}), "
               f"{key}, {K})")
    ek.line(f"key = (tl.zeros([{kb}], {itype}) + {key})"
            f".to({_TL_INT[kdt]})")
    ek.line("tl.store(key_ptr + p, key, mask=p_ok)")

    two = bool(cols)
    wide = ".to(tl.int64)" if itype == "tl.int64" else ""

    def walk(bounds) -> Emitter:
        """A program's columns, then ``bounds`` (which set ``lo`` and
        ``hi``), then the walk of sorted positions [lo, hi) ``bs`` at a
        time into ``bs`` float32 register chains (position lo + i feeds
        chain i), summed in one fixed tree at the end."""
        em = Emitter(low.shapes, seg, cols, itype, " " * 4, bs, bc)
        em.args = args
        if two:
            em.line(f"c = tl.program_id(1){wide} * {bc} + "
                    f"tl.arange(0, {bc}){wide}")
            em.line(f"c_ok = c < {n_c}")
            iterators(em, cols, sizes, "c", "q")
            em.line("Q_ok = c_ok[None, :]")
            for a in cols:
                em.line(f"Q{a} = q{a}[None, :]")
        for line in bounds:
            em.line(line)
        block = f"[{bs}, {bc}]" if two else f"[{bs}]"
        em.line(f"acc = tl.full({block}, {ident}, tl.float32)")
        em.line(f"for s0 in range(lo, hi, {bs}):")
        em.indent = " " * 8
        em.line(f"s = s0 + tl.arange(0, {bs})")
        em.line("s_ok = s < hi")
        em.line(f"p = tl.load(perm_ptr + s, mask=s_ok, other=0).to({itype})")
        iterators(em, seg, sizes, "p", "p")
        if two:
            em.line("P_ok = s_ok[:, None]")
            for a in seg:
                em.line(f"P{a} = p{a}[:, None]")
        else:
            em.line("p_ok = s_ok")
        rs = Scope(em, kernel, low, mr.setup_env, mr.epoch_regs,
                   gathers=mr.gather_reads)
        rs.run(kernel.setup)
        value = rs.val(kernel.expr.res)
        valid = (["P_ok", "Q_ok"] if two else ["p_ok"]) + rs.bounds_mask(
            mr.dyn_bounds)
        em.line(f"v = tl.where({' & '.join(valid)}, {value.f32()}, "
                f"{ident})")
        em.line(f"acc = {_COMBINE[mode].format(a='acc', b='v')}")
        em.indent = " " * 4
        reduced = f"{_REDUCE[mode]}(acc, axis=0)"
        em.line(f"acc = {reduced}" if two
                else f"acc = tl.zeros([1], tl.float32) + {reduced}")
        return em

    # one grid: program k < K owns row k and sums its segment's first
    # piece; program K + e sums the piece of the segment that runs into
    # sorted chunk e from an earlier chunk, if any.  A segment in one chunk
    # is written by its owner; the pieces of a longer one go to scratch,
    # and the last of them to arrive (an int32 count a segment, reset by
    # that program) adds them in chunk order and writes the row
    chunks = -(-n_pos // L)
    ncb = -(-n_c // bc)
    slot = f" * {n_c} + c" if two else " + tl.zeros([1], tl.int32)"
    mask = ", mask=c_ok" if two else ""
    er = walk([
        f"pid = tl.program_id(0){wide}",
        f"owner = pid < {K}",
        f"lo_c = (pid - {K}) * {L}",
        f"live = (pid >= {K}) & (lo_c < tl.load(seg_ptr + {K}))",
        f"row = tl.where(owner, pid, tl.load(skey_ptr + lo_c, mask=live, "
        f"other={K}))",
        "start = tl.load(seg_ptr + row)",
        f"stop = tl.load(seg_ptr + row + 1, mask=row < {K}, other=0)",
        "live = owner | (live & (start < lo_c))",
        "lo = tl.where(owner, start, lo_c)",
        f"hi = tl.where(owner, tl.minimum(stop, (start // {L} + 1) * {L}), "
        f"tl.where(live, tl.minimum(stop, lo_c + {L}), lo_c))"])
    er.line(f"c0 = start // {L}")
    er.line(f"c1 = (stop - 1) // {L}")
    er.line("multi = (stop > start) & (c1 > c0)")
    o_terms = [] if two else [f"tl.zeros([1], {itype})"]
    for d in sc["keyed"]:
        ks = sc["kstrides"][d]
        code = "row" if ks == 1 else f"row // {ks}"
        if d != sc["keyed"][0]:
            code = f"({code}) % {int(out_shape[d])}"
        o_terms.append(code if strides[d] == 1 else f"({code}) * {strides[d]}")
    for d, index in enumerate(write.dims):
        if d not in sc["keyed"]:
            axis = low._pure_iter(index)
            o_terms.append(f"q{axis}" if strides[d] == 1
                           else f"q{axis} * {strides[d]}")

    def write_row():
        if mr.phantom != 1 and mode == "add":
            er.line(f"acc = acc * {lit(float(mr.phantom))}")
        er.line(f"o = {' + '.join(o_terms)}")
        return _store(er, low, mode, "c_ok" if two else None)

    er.line("if owner & ~multi:")
    er.indent = " " * 8
    out_args = write_row()
    er.indent = " " * 4
    er.line("if live & multi:")
    er.line(f"    at = tl.where(owner, c0, pid - {K} + {chunks})")
    er.line(f"    tl.store(part_ptr + at{slot}, acc{mask})")
    er.line("    tl.debug_barrier()")
    er.line(f"    n = tl.atomic_add(cnt_ptr + c0 * {ncb} + tl.program_id(1), 1)")
    er.line("    if n == c1 - c0:")
    er.line(f"        acc = tl.load(part_ptr + c0{slot}{mask}, "
            "cache_modifier=\".cg\")")
    er.line("        for e in range(c0 + 1, c1 + 1):")
    er.line(f"            carried = tl.load(part_ptr + (e + {chunks}){slot}"
            f"{mask}, cache_modifier=\".cg\")")
    er.line(f"            acc = {_COMBINE[mode].format(a='acc', b='carried')}")
    er.indent = " " * 12
    write_row()
    er.line(f"tl.store(cnt_ptr + c0 * {ncb} + tl.program_id(1), 0)")
    er.indent = " " * 4
    operands = "".join(f", x{k}_ptr" for k in range(len(args))) + ", epoch"

    nbytes = _bytes(low, kernel, low.fresh_output)
    design = (
        f"owner-computes over destination segments: the keys kernel writes "
        f"the destination row of each of {n_pos} positions, a stable "
        f"sort of the keys groups them into {K} segments, then "
        f"each program owns one row "
        f"and {bc} of its {n_c} columns, walks the row's positions "
        f"{bs} at a time in position order into {bs} float32 register "
        "chains, sums them in a fixed tree and writes each owned output "
        "element once (no float atomics); pieces of a segment past a "
        f"multiple of {L} sorted positions are summed by programs of their "
        "own and the last of a segment's pieces to finish adds them in "
        "order"
    )
    source = _source(nbytes, design, [
        ("egt_scatter_keys", "key_ptr" + operands, ek.lines),
        ("egt_mapreduce", out_args + ", part_ptr, cnt_ptr, skey_ptr, "
         "perm_ptr, seg_ptr" + operands, er.lines)])
    plan = {"grid": (K + (chunks if chunks > 1 else 0), ncb),
            "num_warps": warps, "block_s": bs, "block_c": bc,
            "bytes": nbytes, "positions": n_pos, "K": K, "key_dtype": kdt,
            "keys_grid": -(-n_pos // kb), "chunks": chunks,
            "part": 2 * chunks * max(n_c, 1), "counts": chunks * ncb}
    return source, list(args), plan


def _bytes(low, kernel, fresh: bool) -> int:
    """Bytes a map/reduce kernel must move: each operand read once, the
    output written once and, unless it is fresh, its previous value read
    once."""
    item = torch.tensor([], dtype=low.dtype).element_size()
    tids = {r.tensor for r in kernel.reads}
    total = sum(int(np.prod(low.shapes[t], dtype=np.int64)) for t in tids)
    out = int(np.prod(low.shapes[kernel.write.tensor], dtype=np.int64))
    return (total + (1 if fresh else 2) * out) * item


class MapReduceKernel:
    """One generated B5 kernel: its source, operands and launch plan, and
    the plain version of the same IR kernel."""

    def __init__(self, mr):
        self.source, self.tids, self.plan = emit_mapreduce(mr)
        self.out_tid = mr.kernel.write.tensor
        self.mode = mr.kernel.write.accumulate
        self.scatter = mr.scatter is not None
        self.fresh = mr.low.fresh_output
        self.dtype = mr.low.dtype
        self.plain = mr.plain
        self.handles = {}  # function name -> loaded Triton kernel
        self.rows = {}  # device -> a scatter's rows 0..K (group)
        self.counts = {}  # device -> a scatter's piece counts (scatter)


def mapreduce_plain(kern: MapReduceKernel, tensors: dict, epoch: int):
    """The plain version: the port's own lowering of the same IR kernel."""
    return kern.plain(tensors, epoch)


def _operands(kern, tensors, device) -> list[torch.Tensor]:
    ops = []
    for tid in kern.tids:
        t = tensors[tid]
        if t.device != device or t.dtype != kern.dtype:
            raise ValueError(
                f"operand t{tid} is {t.dtype} on {t.device}; the kernel "
                f"takes {kern.dtype} on {device}")
        ops.append(t.contiguous())
    return ops


def group(kern: MapReduceKernel, ops, epoch: int, device) -> dict:
    """A scatter's keys, launched on the card, and their grouping: the
    keys sorted stably (``sorted``), the positions in that order
    (``perm``) and the segment ``offsets`` [0, K] (``offsets[K]`` counts
    the positions kept).  The grouping is ``torch.sort`` and
    ``torch.searchsorted`` on the keys alone, no value moves: the
    bookkeeping before the kernel, O(positions + rows) memory at every
    size."""
    plan = kern.plan
    keys = torch.empty(plan["positions"], dtype=plan["key_dtype"],
                       device=device)
    triton_build.launch(triton_build.handle(kern, "egt_scatter_keys"),
                        (plan["keys_grid"],), 4, keys, *ops, int(epoch))
    skeys, perm = torch.sort(keys, stable=True)
    rows = kern.rows.get(device)
    if rows is None:  # the rows 0..K, made once a device
        rows = kern.rows[device] = torch.arange(
            plan["K"] + 1, dtype=keys.dtype, device=device)
    offsets = torch.searchsorted(skeys, rows,
                                 out_int32=keys.numel() <= _INT32_LIMIT)
    return {"keys": keys, "sorted": skeys, "perm": perm, "offsets": offsets}


def scatter(kern: MapReduceKernel, out, prevs, ops, epoch: int) -> None:
    """Launch a scatter's kernels into ``out``: the keys and their
    grouping, then the owners' walk with the pieces of long segments."""
    plan = kern.plan
    ws = group(kern, ops, epoch, out.device)
    long = plan["chunks"] > 1  # else no segment crosses a chunk
    part = torch.empty(plan["part"] if long else 1, dtype=torch.float32,
                       device=out.device)
    counts = kern.counts.get(out.device)
    if counts is None:  # each segment's count of finished pieces, left 0
        counts = kern.counts[out.device] = torch.zeros(
            plan["counts"] if long else 1, dtype=torch.int32,
            device=out.device)
    triton_build.launch(triton_build.handle(kern, "egt_mapreduce"),
                        plan["grid"], plan["num_warps"], out, *prevs, part,
                        counts, ws["sorted"], ws["perm"], ws["offsets"],
                        *ops, int(epoch))


def mapreduce_impl(kern: MapReduceKernel, tensors: dict,
                   epoch: int) -> torch.Tensor:
    """The new value of the kernel's output tensor.  CUDA tensors launch
    the generated kernel or raise; CPU tensors run the plain version."""
    prev = tensors[kern.out_tid]
    if prev.device.type == "cpu":
        return mapreduce_plain(kern, tensors, epoch)
    if prev.device.type != "cuda":
        raise ValueError(
            f"the map/reduce kernel runs on CUDA tensors, not on "
            f"{prev.device}")
    if kern.dtype not in _TL_DTYPE or prev.dtype != kern.dtype:
        raise ValueError(f"the map/reduce kernel cannot store {prev.dtype}")
    ops = _operands(kern, tensors, prev.device)
    plan = kern.plan
    out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    prevs = () if kern.fresh else (prev.contiguous(),)
    if kern.scatter:
        scatter(kern, out, prevs, ops, epoch)
    else:
        triton_build.launch(triton_build.handle(kern, "egt_mapreduce"),
                            (plan["grid"],), plan["num_warps"], out,
                            *prevs, *ops, int(epoch))
    global launches
    launches += 1
    return out
