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
* a plain write stores ``prev (+|max|min) value`` into a fresh tensor; a
  scatter adds (or takes the max or min) at its computed address with
  one float32 atomic per position, into a float32 copy of ``prev``.

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
_ATOMIC = {"add": "tl.atomic_add", "max": "tl.atomic_max",
           "min": "tl.atomic_min"}
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
    scatter = mr.scatter is not None
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
    out_dt = _TL_DTYPE[low.dtype]
    if scatter:
        sc = mr.scatter
        strides = contiguous_strides(out_shape)
        flat = scope._flat(write.dims, sc)
        terms = []
        for d, index in enumerate(write.dims):
            if d in sc["dims"]:
                idx = scope._unravel(flat, sc, d, out_shape)
            else:
                idx = scope.index(index)
            terms.append(scope._scaled(idx, strides[d]))
        addr = scope._sum(terms)
        ok = ["p_ok"]
        if flat.const:
            if not 0 <= flat.code < sc["V"]:
                ok.append("False")
        else:
            ok.append(f"({flat.code} >= 0) & ({flat.code} < {sc['V']})")
        if addr.const:
            addr = Val(f"tl.zeros([{bp}], {itype}) + {addr.code}", "i",
                       p_axes)
        em.line(f"{_ATOMIC[mode]}(out_ptr + {addr.code}, acc, "
                f"mask={' & '.join(ok)})")
        args = "out_ptr"
    else:
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
        if low.fresh_output:
            em.line(f"tl.store(out_ptr + o, acc.to({out_dt}), mask=p_ok)")
            args = "out_ptr"
        else:
            em.line("prev = tl.load(prev_ptr + o, mask=p_ok, other=0.0)"
                    ".to(tl.float32)")
            em.line(f"tl.store(out_ptr + o, "
                    f"({_COMBINE[mode].format(a='prev', b='acc')})"
                    f".to({out_dt}), mask=p_ok)")
            args = "out_ptr, prev_ptr"
    args += "".join(f", x{k}_ptr" for k in range(len(em.args))) + ", epoch"

    nbytes = _bytes(low, kernel, low.fresh_output)
    design = (
        f"each program owns {bp} of {n_p} write positions"
        + (f" and loops over {n_q} reduced positions {bq} at a time, "
           "accumulating in float32 registers" if q_axes else "")
        + (f"; one float32 {mode} atomic per position at its computed "
           "address" if scatter else "; every operand element is read "
           "once and each output element written once")
    )
    source = (
        "# Generated by exprgrad_torch.ops.mapreduce: kernel B5, the "
        "port of\n# exprgrad_tpu/backend/pallasgen.py:1804 "
        "PallasMapReduce.lower.\n"
        f"# Bound: bytes; {nbytes} bytes read and written, "
        f"{nbytes / 3.35e12 * 1e3:.6f} ms at 3.35 TB/s.\n"
        f"# Design: {design}.\n"
        + HEADER + "\n\n"
        '@triton.jit(do_not_specialize=["epoch"])\n'
        f"def egt_mapreduce({args}):\n"
        + "\n".join(em.lines) + "\n"
    )
    plan = {"grid": (n_p + bp - 1) // bp, "num_warps": warps,
            "block_p": bp, "block_q": bq, "bytes": nbytes}
    return source, list(em.args), plan


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
    fn = triton_build.load(kern.source, "egt_mapreduce")
    grid = (kern.plan["grid"],)
    warps = kern.plan["num_warps"]
    if kern.scatter:
        if kern.fresh:
            out = torch.full(prev.shape, accumulation_identity(kern.mode),
                             dtype=torch.float32, device=prev.device)
        else:
            out = prev.to(torch.float32, copy=True).contiguous()
        triton_build.launch(fn, grid, warps, out, *ops, int(epoch))
        out = out if prev.dtype == torch.float32 else out.to(prev.dtype)
    else:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
        prev = () if kern.fresh else (prev.contiguous(),)
        triton_build.launch(fn, grid, warps, out, *prev, *ops, int(epoch))
    global launches
    launches += 1
    return out
