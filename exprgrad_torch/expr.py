"""Expression-builder half of the DSL.

The reference embeds its language in Nim macros (exprgrad/dsl.nim,
exprgrad/parser.nim:20-46); here the same language is embedded in Python via
operator overloading.  ``Scalar``/``Index``/``Boolean``/``Array`` wrap an
``ExprNode`` tree which is lowered to kernel IR when a kernel is built.

Type discipline matches the reference (4 types, no implicit conversions
between Scalar and Index), except that Python ``int``/``float`` literals are
coerced to the type required by context, since Python numbers carry no
Scalar/Index distinction the way Nim's ``2`` vs ``2.0`` do.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Optional, Sequence, Union

from .errors import ParserError
from .ir import Op

if TYPE_CHECKING:
    from .fun import Fun


class NodeKind(enum.Enum):
    INSTR = "instr"
    ITER = "iter"
    READ = "read"


class ExprNode:
    """One node of the untyped expression tree (reference ExprBuilder)."""

    __slots__ = (
        "kind",
        "children",
        "tensor",
        "op",
        "index_lit",
        "scalar_lit",
        "bool_lit",
        "dim",
        "iter_name",
        "is_raw",
        "label",
        "_res",
    )

    def __init__(
        self,
        kind: NodeKind,
        op: Optional[Op] = None,
        children: Optional[list["ExprNode"]] = None,
        tensor: Optional["Fun"] = None,
        index_lit: int = 0,
        scalar_lit: float = 0.0,
        bool_lit: bool = False,
        dim: int = 0,
        iter_name: str = "",
        is_raw: bool = False,
        label: str = "",
    ) -> None:
        self.kind = kind
        self.op = op
        self.children: list[ExprNode] = children or []
        self.tensor = tensor
        self.index_lit = index_lit
        self.scalar_lit = scalar_lit
        self.bool_lit = bool_lit
        self.dim = dim
        self.iter_name = iter_name
        self.is_raw = is_raw
        self.label = label
        # per-build register cache: (build_gen, block_id) -> reg
        self._res: dict[tuple[int, int], int] = {}


# ---------------------------------------------------------------------------
# typed wrappers
# ---------------------------------------------------------------------------

class _Wrapped:
    __slots__ = ("node",)
    __hash__ = object.__hash__

    def __init__(self, node: ExprNode) -> None:
        self.node = node


def _instr(op: Op, *children: ExprNode, **kw) -> ExprNode:
    return ExprNode(NodeKind.INSTR, op=op, children=list(children), **kw)


class Boolean(_Wrapped):
    def __and__(self, other: "Boolean") -> "Boolean":
        return Boolean(_instr(Op.AND, self.node, as_boolean(other).node))

    def __or__(self, other: "Boolean") -> "Boolean":
        return Boolean(_instr(Op.OR, self.node, as_boolean(other).node))

    def __invert__(self) -> "Boolean":
        # not x == select(x, false, true); reference has no Not instr either
        return Boolean(
            _instr(
                Op.SELECT,
                self.node,
                _instr(Op.BOOL, bool_lit=False),
                _instr(Op.BOOL, bool_lit=True),
            )
        )

    def __eq__(self, other) -> "Boolean":  # type: ignore[override]
        return Boolean(_instr(Op.EQ, self.node, as_boolean(other).node))


class Scalar(_Wrapped):
    def _bin(self, op: Op, other, swap: bool = False) -> "Scalar":
        a, b = self.node, as_scalar(other).node
        if swap:
            a, b = b, a
        return Scalar(_instr(op, a, b))

    def __add__(self, other) -> "Scalar":
        return self._bin(Op.ADD, other)

    __radd__ = __add__

    def __sub__(self, other) -> "Scalar":
        return self._bin(Op.SUB, other)

    def __rsub__(self, other) -> "Scalar":
        return self._bin(Op.SUB, other, swap=True)

    def __mul__(self, other) -> "Scalar":
        return self._bin(Op.MUL, other)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "Scalar":
        return self._bin(Op.DIV, other)

    def __rtruediv__(self, other) -> "Scalar":
        return self._bin(Op.DIV, other, swap=True)

    def __neg__(self) -> "Scalar":
        return Scalar(_instr(Op.NEG, self.node))

    def __pow__(self, other) -> "Scalar":
        return self._bin(Op.POW, other)

    def __rpow__(self, other) -> "Scalar":
        return self._bin(Op.POW, other, swap=True)

    # comparisons build Boolean exprs; > and >= are flipped < and <=
    def __lt__(self, other) -> Boolean:
        return Boolean(_instr(Op.LT, self.node, as_scalar(other).node))

    def __le__(self, other) -> Boolean:
        return Boolean(_instr(Op.LE, self.node, as_scalar(other).node))

    def __gt__(self, other) -> Boolean:
        return Boolean(_instr(Op.LT, as_scalar(other).node, self.node))

    def __ge__(self, other) -> Boolean:
        return Boolean(_instr(Op.LE, as_scalar(other).node, self.node))

    def __eq__(self, other) -> Boolean:  # type: ignore[override]
        return Boolean(_instr(Op.EQ, self.node, as_scalar(other).node))


class Index(_Wrapped):
    def _bin(self, op: Op, other, swap: bool = False) -> "Index":
        a, b = self.node, as_index(other).node
        if swap:
            a, b = b, a
        return Index(_instr(op, a, b))

    def __add__(self, other) -> "Index":
        return self._bin(Op.ADD, other)

    __radd__ = __add__

    def __sub__(self, other) -> "Index":
        return self._bin(Op.SUB, other)

    def __rsub__(self, other) -> "Index":
        return self._bin(Op.SUB, other, swap=True)

    def __mul__(self, other) -> "Index":
        return self._bin(Op.MUL, other)

    __rmul__ = __mul__

    def __floordiv__(self, other) -> "Index":
        """Truncated integer division, like Nim ``div`` (see README.md:210)."""
        return self._bin(Op.IDX_DIV, other)

    def __rfloordiv__(self, other) -> "Index":
        return self._bin(Op.IDX_DIV, other, swap=True)

    def __mod__(self, other) -> "Index":
        return self._bin(Op.MOD, other)

    def __rmod__(self, other) -> "Index":
        return self._bin(Op.MOD, other, swap=True)

    def __neg__(self) -> "Index":
        return Index(_instr(Op.NEG, self.node))

    def __lt__(self, other) -> Boolean:
        return Boolean(_instr(Op.LT, self.node, as_index(other).node))

    def __le__(self, other) -> Boolean:
        return Boolean(_instr(Op.LE, self.node, as_index(other).node))

    def __gt__(self, other) -> Boolean:
        return Boolean(_instr(Op.LT, as_index(other).node, self.node))

    def __ge__(self, other) -> Boolean:
        return Boolean(_instr(Op.LE, as_index(other).node, self.node))

    def __eq__(self, other) -> Boolean:  # type: ignore[override]
        return Boolean(_instr(Op.EQ, self.node, as_index(other).node))


class Array(_Wrapped):
    def __getitem__(self, index) -> Scalar:
        # item type is resolved by the type checker; reads of nested arrays
        # produce Array values again, so we return a generic wrapper that the
        # caller re-wraps if needed.
        node = _instr(Op.ARRAY_READ, self.node, as_index(index).node)
        return _ArrayItem(node)

    @property
    def length(self) -> Index:
        return Index(_instr(Op.ARRAY_LEN, self.node))


class _ArrayItem(Scalar, Array):
    """Result of Array[i]: usable as Scalar or as nested Array."""


# ---------------------------------------------------------------------------
# coercions
# ---------------------------------------------------------------------------

def as_scalar(x) -> Scalar:
    if isinstance(x, Scalar):
        return x
    if isinstance(x, Index):
        raise ParserError(
            "cannot use an Index where a Scalar is expected; use to_scalar()"
        )
    if isinstance(x, bool):
        raise ParserError("cannot use a bool where a Scalar is expected")
    if isinstance(x, (int, float)):
        return Scalar(_instr(Op.SCALAR, scalar_lit=float(x)))
    raise ParserError(f"cannot convert {type(x).__name__} to Scalar")


def as_index(x) -> Index:
    if isinstance(x, Index):
        return x
    if isinstance(x, Scalar):
        raise ParserError(
            "cannot use a Scalar where an Index is expected; use to_index()"
        )
    if isinstance(x, bool):
        raise ParserError("cannot use a bool where an Index is expected")
    if isinstance(x, int):
        return Index(_instr(Op.IDX, index_lit=x))
    raise ParserError(f"cannot convert {type(x).__name__} to Index")


def as_boolean(x) -> Boolean:
    if isinstance(x, Boolean):
        return x
    if isinstance(x, bool):
        return Boolean(_instr(Op.BOOL, bool_lit=x))
    raise ParserError(f"cannot convert {type(x).__name__} to Boolean")


# ---------------------------------------------------------------------------
# free functions of the language (reference dsl.nim + README instruction table)
# ---------------------------------------------------------------------------

def iters(*names: str):
    """Create loop iterators.  ``y, x = iters("y", "x")``."""
    out = tuple(Index(ExprNode(NodeKind.ITER, iter_name=n)) for n in names)
    return out[0] if len(out) == 1 else out


def irange(name: str, start, stop) -> Index:
    """Bounded loop iterator: reference ``(x in a..<b)`` (parser.nim:615-633)."""
    node = ExprNode(
        NodeKind.ITER,
        iter_name=name,
        children=[as_index(start).node, as_index(stop).node],
    )
    return Index(node)


def select(cond, a, b):
    """select(cond, a, b): a if cond else b; both sides may be evaluated."""
    cond = as_boolean(cond)
    if isinstance(a, Index) or isinstance(b, Index):
        a2, b2 = as_index(a), as_index(b)
        return Index(_instr(Op.SELECT, cond.node, a2.node, b2.node))
    if isinstance(a, Boolean) or isinstance(b, Boolean):
        a3, b3 = as_boolean(a), as_boolean(b)
        return Boolean(_instr(Op.SELECT, cond.node, a3.node, b3.node))
    a4, b4 = as_scalar(a), as_scalar(b)
    return Scalar(_instr(Op.SELECT, cond.node, a4.node, b4.node))


def _unary(op: Op):
    def fn(x) -> Scalar:
        return Scalar(_instr(op, as_scalar(x).node))

    return fn


sin = _unary(Op.SIN)
cos = _unary(Op.COS)
exp = _unary(Op.EXP)
sqrt = _unary(Op.SQRT)
ln = _unary(Op.LN)
log2 = _unary(Op.LOG2)
log10 = _unary(Op.LOG10)


def debug_scalar(x, label: str = "debug") -> Scalar:
    """Identity that prints its value when the kernel runs (the reference's
    ``debugScalar`` builtin, model.nim:96-100).  In the vectorized TPU
    lowering the whole grid of values prints once per kernel execution."""
    return Scalar(_instr(Op.DEBUG_SCALAR, as_scalar(x).node, label=label))


def debug_index(i, label: str = "debug") -> Index:
    """Identity printing an Index value (reference ``debugIndex``)."""
    return Index(_instr(Op.DEBUG_INDEX, as_index(i).node, label=label))


def pow_(a, b) -> Scalar:
    return Scalar(_instr(Op.POW, as_scalar(a).node, as_scalar(b).node))


def log(x, base) -> Scalar:
    """log(x, base) (reference dsl.nim:60)."""
    return Scalar(_instr(Op.LOG, as_scalar(x).node, as_scalar(base).node))


def sq(x):
    """x * x (works for Scalar and Index; reference dsl.nim:135)."""
    if isinstance(x, Index):
        return x * x
    x = as_scalar(x)
    return x * x


def minimum(a, b):
    if isinstance(a, Index) or isinstance(b, Index):
        a, b = as_index(a), as_index(b)
        return select(a < b, a, b)
    a, b = as_scalar(a), as_scalar(b)
    return select(a < b, a, b)


def maximum(a, b):
    if isinstance(a, Index) or isinstance(b, Index):
        a, b = as_index(a), as_index(b)
        return select(a > b, a, b)
    a, b = as_scalar(a), as_scalar(b)
    return select(a > b, a, b)


def wrap(a, b) -> Index:
    """(a mod b + b) mod b, always in [0, b) (README.md:226)."""
    return Index(_instr(Op.WRAP, as_index(a).node, as_index(b).node))


def to_scalar(x) -> Scalar:
    return Scalar(_instr(Op.TO_SCALAR, as_index(x).node))


def to_index(x) -> Index:
    return Index(_instr(Op.TO_INDEX, as_scalar(x).node))


def epoch() -> Index:
    """Current training epoch as an Index value (reference dsl.nim:74)."""
    return Index(_instr(Op.EPOCH))


def array(values: Sequence) -> Array:
    """Fixed-size array literal; may be nested (reference parser.nim:115-119)."""
    children = []
    for v in values:
        if isinstance(v, (list, tuple)):
            children.append(array(v).node)
        elif isinstance(v, _Wrapped):
            children.append(v.node)
        elif isinstance(v, float) or isinstance(v, int) and not isinstance(v, bool):
            children.append(as_scalar(float(v)).node)
        else:
            raise ParserError(f"invalid array element {v!r}")
    return Array(_instr(Op.ARRAY, *children))


AnyExpr = Union[Scalar, Index, Boolean, Array]
