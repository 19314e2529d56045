"""Loop-nest intermediate representation for the differentiable array language.

This is a fresh, TPU-first redesign of the reference IR (exprgrad/ir.nim).
The core concepts are kept because they *are* the language:

* a ``Kernel`` is one expression evaluated inside implicit nested loops and
  accumulated (``+=``) into a write location (reference ir.nim:211-220);
* index expressions are kept in affine ``LinearIndex`` form
  {setup instrs, factors, constant} so shape/bound inference and fusion can
  reason about them symbolically (reference ir.nim:120-123);
* ``ShapeConstraint`` records how the shape of a produced tensor is derived
  (reference ir.nim:175-192);
* a ``Program`` maps target names to kernel lists over a shared tensor space
  (reference ir.nim:224-270).

Deliberate divergences for the TPU build:

* Kernels stay **structured** (loops + reads + expr + write) all the way into
  the backend; there is no "inline loops to scalar instructions" stage.  The
  reference needs linearized scalar IR because LLVM consumes straight-line
  code (llvmgen.nim); XLA/Pallas consume whole-array operations, so the
  structured form *is* the backend input.  Consequently the instruction set
  has no Loop/Threads/Gpu/Barrier/SharedCache opcodes.
* Ids (registers, tensors) are plain 0-based ints, ``None`` meaning absent.
* Scalar vector ``count`` (SIMD width) is dropped — vectorization is XLA's
  job.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Iterator, Optional

from .errors import StageError


class Op(enum.Enum):
    """Scalar instruction opcodes (reference InstrKind, ir.nim:51-76)."""

    # literals
    IDX = "idx"
    SCALAR = "scalar"
    BOOL = "bool"
    # math
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"          # Scalar division
    IDX_DIV = "idx_div"  # Index division, truncated like Nim `div`
    MOD = "mod"          # Index remainder, truncated like Nim `mod`
    WRAP = "wrap"        # ((a mod b) + b) mod b
    NEG = "neg"
    SIN = "sin"
    COS = "cos"
    EXP = "exp"
    POW = "pow"
    SQRT = "sqrt"
    LOG = "log"          # log(x, base)
    LOG10 = "log10"
    LOG2 = "log2"
    LN = "ln"
    # comparison / logic
    EQ = "eq"
    LT = "lt"
    LE = "le"
    AND = "and"
    OR = "or"
    SELECT = "select"
    # conversions
    TO_SCALAR = "to_scalar"
    TO_INDEX = "to_index"
    # tensor queries (valid in setup/index expressions)
    SHAPE = "shape"
    LEN = "len"
    SHAPE_LEN = "shape_len"
    # arrays
    ARRAY = "array"
    ARRAY_LEN = "array_len"
    ARRAY_READ = "array_read"
    # misc
    EPOCH = "epoch"
    # debug builtins (reference debugScalar/debugIndex, model.nim:96-100):
    # identity ops that print their argument when the kernel executes
    DEBUG_SCALAR = "debug_scalar"
    DEBUG_INDEX = "debug_index"


class TypeKind(enum.Enum):
    SCALAR = "Scalar"
    INDEX = "Index"
    BOOLEAN = "Boolean"
    ARRAY = "Array"


@dataclass(frozen=True)
class Type:
    kind: TypeKind
    # for ARRAY:
    length: int = 0
    item: Optional["Type"] = None

    def __str__(self) -> str:
        if self.kind == TypeKind.ARRAY:
            return f"Array[{self.length}, {self.item}]"
        return self.kind.value


SCALAR_T = Type(TypeKind.SCALAR)
INDEX_T = Type(TypeKind.INDEX)
BOOLEAN_T = Type(TypeKind.BOOLEAN)


@dataclass
class Instr:
    """One SSA instruction.  ``res`` is the defined register (or None)."""

    op: Op
    args: list[int] = field(default_factory=list)
    res: Optional[int] = None
    tensor: Optional[int] = None
    # immediates
    index_lit: int = 0
    scalar_lit: float = 0.0
    bool_lit: bool = False
    dim: int = 0  # for Op.SHAPE (may be negative, python-style)
    label: str = ""  # for Op.DEBUG_* print tags

    def copy(self) -> "Instr":
        return replace(self, args=list(self.args))

    def key(self):
        """Structural identity (used for dedup)."""
        return (
            self.op,
            tuple(self.args),
            self.tensor,
            self.index_lit,
            self.scalar_lit,
            self.bool_lit,
            self.dim,
        )


@dataclass
class Register:
    name: str = ""
    typ: Optional[Type] = None


@dataclass
class Expr:
    instrs: list[Instr] = field(default_factory=list)
    res: Optional[int] = None

    def copy(self) -> "Expr":
        return Expr([i.copy() for i in self.instrs], self.res)


@dataclass
class LinearIndex:
    """Affine index form: sum(factors[reg] * reg) + constant.

    ``setup`` holds the instructions computing any non-loop registers used in
    ``factors`` (reference ir.nim:120-123, arithmetic ir.nim:618-663).
    """

    setup: list[Instr] = field(default_factory=list)
    factors: dict[int, int] = field(default_factory=dict)
    constant: int = 0

    # --- constructors -------------------------------------------------
    @staticmethod
    def of_const(c: int) -> "LinearIndex":
        return LinearIndex(constant=c)

    @staticmethod
    def of_reg(reg: int, factor: int = 1) -> "LinearIndex":
        return LinearIndex(factors={reg: factor})

    # --- arithmetic ---------------------------------------------------
    def scaled(self, c: int) -> "LinearIndex":
        if c == 0:
            return LinearIndex()
        return LinearIndex(
            setup=[i.copy() for i in self.setup],
            factors={r: f * c for r, f in self.factors.items()},
            constant=self.constant * c,
        )

    def __add__(self, other: "LinearIndex") -> "LinearIndex":
        out = LinearIndex(
            setup=[i.copy() for i in self.setup] + [i.copy() for i in other.setup],
            factors=dict(self.factors),
            constant=self.constant + other.constant,
        )
        for reg, f in other.factors.items():
            nf = out.factors.get(reg, 0) + f
            if nf == 0:
                out.factors.pop(reg, None)
            else:
                out.factors[reg] = nf
        return out

    def __sub__(self, other: "LinearIndex") -> "LinearIndex":
        return self + other.scaled(-1)

    def __neg__(self) -> "LinearIndex":
        return self.scaled(-1)

    def mul(self, other: "LinearIndex") -> Optional["LinearIndex"]:
        """Product if at least one side is constant, else None."""
        if not self.factors:
            return other.scaled(self.constant)
        if not other.factors:
            return self.scaled(other.constant)
        return None

    # --- queries ------------------------------------------------------
    def only_register(self) -> Optional[int]:
        """The register r when self == 1*r (reference passes.nim:995-999)."""
        if self.constant == 0 and len(self.factors) == 1:
            (reg, f), = self.factors.items()
            if f == 1:
                return reg
        return None

    def eval(self, values: dict[int, int]) -> int:
        return self.constant + sum(f * values[r] for r, f in self.factors.items())

    def copy(self) -> "LinearIndex":
        return LinearIndex(
            [i.copy() for i in self.setup], dict(self.factors), self.constant
        )

    def factors_key(self):
        return tuple(sorted(self.factors.items()))


class LoopMode(enum.IntEnum):
    NONE = 0
    INDEPENDENT = 1  # every iteration writes a distinct location
    PARALLEL = 2     # chosen as a parallel/grid dimension by the scheduler


@dataclass
class LoopSchedule:
    """User schedule hints for one loop (reference ir.nim:130-134).

    ``tile_size`` maps to Pallas block sizes; default retuned for the MXU
    (the reference default was 16 for OpenCL workgroups, ir.nim:283).
    """

    tile_size: int = 128
    tile: bool = False
    parallel: bool = False
    share_cache: bool = False


@dataclass
class TensorSchedule:
    cache: bool = False  # stage this operand through VMEM explicitly


@dataclass
class Loop:
    iter_reg: int
    mode: LoopMode = LoopMode.NONE
    has_bounds: bool = False
    start: LinearIndex = field(default_factory=LinearIndex)
    stop: LinearIndex = field(default_factory=LinearIndex)
    step: int = 1
    schedule: LoopSchedule = field(default_factory=LoopSchedule)

    def copy(self) -> "Loop":
        return Loop(
            iter_reg=self.iter_reg,
            mode=self.mode,
            has_bounds=self.has_bounds,
            start=self.start.copy(),
            stop=self.stop.copy(),
            step=self.step,
            schedule=replace(self.schedule),
        )


@dataclass
class TensorOp:
    """A read from or write to a tensor at affine indices.

    ``accumulate`` (writes only) selects the reduction the implicit loops
    perform: "add" (the reference's ``++=``), "max" or "min" — extensions
    enabling true max-reductions (exact stable softmax, global pooling) with
    subgradient autodiff.
    """

    tensor: int
    dims: list[LinearIndex] = field(default_factory=list)
    data: Optional[int] = None  # register holding the read/written scalar
    is_raw: bool = False        # flat `{i}` access instead of per-dim `[i,j]`
    accumulate: str = "add"     # "add" | "max" | "min" (writes only)
    schedule: TensorSchedule = field(default_factory=TensorSchedule)

    def copy(self) -> "TensorOp":
        return TensorOp(
            tensor=self.tensor,
            dims=[d.copy() for d in self.dims],
            data=self.data,
            is_raw=self.is_raw,
            accumulate=self.accumulate,
            schedule=replace(self.schedule),
        )


class ShapeConstrKind(enum.Enum):
    NONE = "none"
    DIMS = "dims"      # explicit per-dim index expressions
    LINEAR = "linear"  # solve read/write affine index ranges (einsum inference)
    COPY = "copy"      # same shape as another tensor
    RANK = "rank"      # rank is known, sizes are not


class ShapeConstrPriority(enum.IntEnum):
    CONDITION = 0
    INFERRED = 1
    USER = 2


@dataclass
class ShapeConstraint:
    kind: ShapeConstrKind
    dest: int
    priority: ShapeConstrPriority = ShapeConstrPriority.INFERRED
    rank: int = 0
    dims: list[LinearIndex] = field(default_factory=list)
    # LINEAR: tensor -> per-dim list of index expressions seen in reads
    reads: dict[int, list[list[LinearIndex]]] = field(default_factory=dict)
    write: list[LinearIndex] = field(default_factory=list)
    src: Optional[int] = None  # COPY

    def copy(self) -> "ShapeConstraint":
        return ShapeConstraint(
            kind=self.kind,
            dest=self.dest,
            priority=self.priority,
            rank=self.rank,
            dims=[d.copy() for d in self.dims],
            reads={
                t: [[i.copy() for i in idxs] for idxs in per_dim]
                for t, per_dim in self.reads.items()
            },
            write=[d.copy() for d in self.write],
            src=self.src,
        )

    def deps(self) -> Iterator[int]:
        """Tensors whose shapes must be known first (ref passes.nim:1139-1150)."""
        if self.kind == ShapeConstrKind.DIMS:
            for d in self.dims:
                for instr in d.setup:
                    if instr.tensor is not None:
                        yield instr.tensor
        elif self.kind == ShapeConstrKind.LINEAR:
            yield from self.reads.keys()
        elif self.kind == ShapeConstrKind.COPY:
            assert self.src is not None
            yield self.src


class GenKind(enum.Enum):
    NONE = "none"
    BACKWARDS = "backwards"
    GRADIENT = "gradient"
    RESHAPE = "reshape"


@dataclass
class Generator:
    kind: GenKind = GenKind.NONE
    tensor: Optional[int] = None
    reshape: list[int] = field(default_factory=list)


@dataclass
class Extern:
    """An opaque registered operation invoked as a kernel.

    The TPU-native generalization of the reference's customGrad seam
    (parser.nim:568-589): where the reference can only substitute hand
    written *DSL* gradient kernels, an extern kernel calls a registered
    backend primitive (e.g. a fused Pallas flash-attention kernel) for the
    forward pass and registers extern backward kernels through the same
    custom_grad machinery.  Evaluated by name through
    ``exprgrad_torch.registry`` — a torch implementation, which the
    executor and the numpy interpreter both call.

    ``inputs`` are tensor ids passed positionally.  A registered op may
    return several arrays; each output materializes as its own extern
    kernel selecting ``out_index`` (the registry result is computed once
    per target execution).  The kernel's write accumulates (+=) into the
    output tensor, matching ``++=`` semantics everywhere else.
    """

    name: str
    inputs: list[int] = field(default_factory=list)
    out_index: int = 0
    nout: int = 1
    attrs: dict = field(default_factory=dict)

    def copy(self) -> "Extern":
        return Extern(
            name=self.name,
            inputs=list(self.inputs),
            out_index=self.out_index,
            nout=self.nout,
            attrs=dict(self.attrs),
        )

    def key(self):
        """Memoization key shared by all outputs of one logical call."""
        return (
            self.name,
            tuple(self.inputs),
            tuple(sorted(self.attrs.items())),
        )


@dataclass
class CustomGrad:
    """User-provided gradient kernels (reference KernelGradient, ir.nim:203-209).

    ``grad_placeholders`` maps a forward tensor id to the negative placeholder
    id used inside ``kernels`` to stand for its (not yet allocated) gradient
    tensor; resolved during the generate pass.
    """

    kernels: list["Kernel"] = field(default_factory=list)
    grad_placeholders: dict[int, int] = field(default_factory=dict)
    subs: dict[int, int] = field(default_factory=dict)

    def copy(self) -> "CustomGrad":
        return CustomGrad(
            kernels=[k.copy() for k in self.kernels],
            grad_placeholders=dict(self.grad_placeholders),
            subs=dict(self.subs),
        )


@dataclass
class Kernel:
    generator: Generator = field(default_factory=Generator)
    custom_grad: Optional[CustomGrad] = None
    extern: Optional[Extern] = None
    # recompute kernel emitted by the remat pass: the backend fences its
    # operands together with the anchor tensor (the loss) in ONE
    # optimization_barrier — jax.checkpoint's scheme — so the recompute
    # cannot be hoisted into the forward pass or CSE'd against the
    # original computation (which would keep the activation alive and
    # defeat rematerialization)
    remat: bool = False
    remat_anchor: Optional[int] = None
    # emitted by the autodiff pass (a BACKWARDS generator's region, the
    # recompute kernels included): the executor's backward phase.  Not
    # printed, so the program text is the JAX package's
    derived: bool = False
    regs: list[Register] = field(default_factory=list)
    setup: list[Instr] = field(default_factory=list)
    loops: list[Loop] = field(default_factory=list)
    reads: list[TensorOp] = field(default_factory=list)
    expr: Expr = field(default_factory=Expr)
    write: Optional[TensorOp] = None

    # --- registers ----------------------------------------------------
    def alloc_reg(self, name: str = "", typ: Optional[Type] = None) -> int:
        self.regs.append(Register(name, typ))
        return len(self.regs) - 1

    def tensor_ops(self) -> Iterator[tuple[str, TensorOp]]:
        for read in self.reads:
            yield ("read", read)
        if self.write is not None:
            yield ("write", self.write)

    def input_tensors(self) -> Iterator[int]:
        """Tensors the kernel consumes (reads + extern inputs + the remat
        anchor, which must stay alive for the recompute fence)."""
        for read in self.reads:
            yield read.tensor
        if self.extern is not None:
            yield from self.extern.inputs
        if self.remat_anchor is not None:
            yield self.remat_anchor

    def copy(self) -> "Kernel":
        return Kernel(
            generator=replace(self.generator, reshape=list(self.generator.reshape)),
            custom_grad=self.custom_grad.copy() if self.custom_grad else None,
            extern=self.extern.copy() if self.extern else None,
            remat=self.remat,
            remat_anchor=self.remat_anchor,
            derived=self.derived,
            regs=[replace(r) for r in self.regs],
            setup=[i.copy() for i in self.setup],
            loops=[l.copy() for l in self.loops],
            reads=[r.copy() for r in self.reads],
            expr=self.expr.copy(),
            write=self.write.copy() if self.write else None,
        )


@dataclass
class Target:
    name: str
    output: Optional[int] = None
    tensors: set[int] = field(default_factory=set)
    shapes: list[ShapeConstraint] = field(default_factory=list)
    kernels: list[Kernel] = field(default_factory=list)

    def copy(self) -> "Target":
        return Target(
            name=self.name,
            output=self.output,
            tensors=set(self.tensors),
            shapes=[s.copy() for s in self.shapes],
            kernels=[k.copy() for k in self.kernels],
        )


class TensorKind(enum.Enum):
    RESULT = "result"
    INPUT = "input"
    PARAM = "param"
    CACHE = "cache"
    RANDOM = "random"


@dataclass
class TensorDef:
    kind: TensorKind
    shape: list[int] = field(default_factory=list)  # -1 for unknown dims
    name: str = ""
    init_range: tuple[float, float] = (0.0, 0.0)    # PARAM
    random_range: tuple[float, float] = (0.0, 0.0)  # RANDOM
    cache_of: Optional[int] = None                  # CACHE: tensor whose shape we copy
    remat: bool = False  # recompute in the backward instead of storing


class ScalarType(enum.Enum):
    F32 = "float32"
    F64 = "float64"
    BF16 = "bfloat16"


class Stage(enum.Enum):
    """Pass-manager contract stages (reference ir.nim:247-261)."""

    TYPED = "typed"
    GENERATED = "generated"
    FOLDED = "folded"
    TENSOR_LOOKUPS = "tensor_lookups"
    COLLECTED = "collected"
    SHAPES = "shapes"
    BOUNDS = "bounds"
    SORTED_SHAPES = "sorted_shapes"
    STATIC_SHAPES = "static_shapes"
    INDEPENDENT = "independent"


ALL_STAGES = frozenset(Stage)


@dataclass
class Program:
    tensors: list[TensorDef] = field(default_factory=list)
    inputs: dict[str, int] = field(default_factory=dict)
    params: list[int] = field(default_factory=list)
    caches: list[int] = field(default_factory=list)
    targets: dict[str, Target] = field(default_factory=dict)
    stages: set[Stage] = field(default_factory=set)
    scalar_type: ScalarType = ScalarType.F32

    def alloc_tensor(self, tdef: TensorDef) -> int:
        self.tensors.append(tdef)
        return len(self.tensors) - 1

    def assert_pass(
        self,
        name: str,
        requires: frozenset | set = frozenset(),
        produces: frozenset | set = frozenset(),
        preserves: frozenset | set = frozenset(),
    ) -> None:
        """Check and update stage availability (reference ir.nim:593-601)."""
        missing = set(requires) - self.stages
        if missing:
            raise StageError(
                f"pass {name} requires stages {sorted(s.value for s in missing)}, "
                f"but only {sorted(s.value for s in self.stages)} are available"
            )
        self.stages = (self.stages & set(preserves)) | set(produces)

    def copy(self) -> "Program":
        out = Program(
            tensors=[
                replace(t, shape=list(t.shape)) for t in self.tensors
            ],
            inputs=dict(self.inputs),
            params=list(self.params),
            caches=list(self.caches),
            stages=set(self.stages),
            scalar_type=self.scalar_type,
        )
        out.targets = {name: t.copy() for name, t in self.targets.items()}
        return out


# ---------------------------------------------------------------------------
# substitution helpers (reference ir.nim:398-554)
# ---------------------------------------------------------------------------

def substitute_regs_instrs(instrs: list[Instr], subs: dict[int, int]) -> None:
    for instr in instrs:
        instr.args = [subs.get(a, a) for a in instr.args]
        if instr.res is not None:
            instr.res = subs.get(instr.res, instr.res)


def substitute_regs_linear(index: LinearIndex, subs: dict[int, int]) -> None:
    substitute_regs_instrs(index.setup, subs)
    index.factors = {subs.get(r, r): f for r, f in index.factors.items()}


def substitute_regs_kernel(kernel: Kernel, subs: dict[int, int]) -> None:
    substitute_regs_instrs(kernel.setup, subs)
    for loop in kernel.loops:
        loop.iter_reg = subs.get(loop.iter_reg, loop.iter_reg)
        substitute_regs_linear(loop.start, subs)
        substitute_regs_linear(loop.stop, subs)
    for kind, op in kernel.tensor_ops():
        for d in op.dims:
            substitute_regs_linear(d, subs)
        if op.data is not None:
            op.data = subs.get(op.data, op.data)
    substitute_regs_instrs(kernel.expr.instrs, subs)
    if kernel.expr.res is not None:
        kernel.expr.res = subs.get(kernel.expr.res, kernel.expr.res)


def substitute_tensors_instrs(instrs: list[Instr], subs: dict[int, int]) -> None:
    for instr in instrs:
        if instr.tensor is not None and instr.tensor in subs:
            instr.tensor = subs[instr.tensor]


def substitute_tensors_kernel(kernel: Kernel, subs: dict[int, int]) -> None:
    substitute_tensors_instrs(kernel.setup, subs)
    for loop in kernel.loops:
        substitute_tensors_instrs(loop.start.setup, subs)
        substitute_tensors_instrs(loop.stop.setup, subs)
    for kind, op in kernel.tensor_ops():
        for d in op.dims:
            substitute_tensors_instrs(d.setup, subs)
        if op.tensor in subs:
            op.tensor = subs[op.tensor]
    substitute_tensors_instrs(kernel.expr.instrs, subs)
    if kernel.remat_anchor is not None:
        kernel.remat_anchor = subs.get(kernel.remat_anchor, kernel.remat_anchor)
    if kernel.extern is not None:
        kernel.extern.inputs = [
            subs.get(t, t) for t in kernel.extern.inputs
        ]
    if kernel.custom_grad is not None:
        cg = kernel.custom_grad
        if cg.subs:
            for a, b in list(cg.subs.items()):
                if b in subs:
                    cg.subs[a] = subs[b]
        else:
            cg.subs = dict(subs)


# ---------------------------------------------------------------------------
# Interval arithmetic (reference ir.nim:665-675)
# ---------------------------------------------------------------------------

@dataclass
class Interval:
    min: int = 0
    max: int = 0

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.min + other.min, self.max + other.max)

    def scaled(self, c: int) -> "Interval":
        if c < 0:
            return Interval(c * self.max, c * self.min)
        return Interval(c * self.min, c * self.max)
