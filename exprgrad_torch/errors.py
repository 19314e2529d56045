"""Error hierarchy for the exprgrad-tpu compiler.

Parity: reference error hierarchy in exprgrad/ir.nim:20-29 (CompilerError and
subclasses). Names are adjusted to avoid shadowing Python builtins.
"""


class ExprgradError(Exception):
    """Base class for all compiler / runtime errors."""


class ParserError(ExprgradError):
    """Raised while building the kernel graph from the DSL."""


class KernelTypeError(ExprgradError):
    """Type error inside a kernel expression (reference: TypeError)."""


class GradientError(ExprgradError):
    """Raised when a kernel cannot be differentiated."""


class GeneratorError(ExprgradError):
    """Raised while expanding generator kernels (backwards/gradient/reshape)."""


class StageError(ExprgradError):
    """A compiler pass ran before its required stages were available."""


class ShapeError(ExprgradError):
    """Tensor shape inference failure or shape mismatch."""


class ValidationError(ExprgradError):
    """IR validation failure (use-before-def and friends)."""


class ModelRuntimeError(ExprgradError):
    """Runtime usage error (unknown target/input, ...). Reference: RuntimeError."""


class RematWarning(UserWarning):
    """A ``fun.remat()`` mark had no effect (e.g. the tensor is produced
    by an extern op, whose per-execution memoization would deduplicate a
    recompute right back).  Marks are never silently ignored."""


class ScheduleWarning(UserWarning):
    """A user schedule (tile/parallel/cache) could not be honored or was
    overridden by the cost model; the kernel fell back to the XLA path.

    The reference compiles any scheduled kernel through its GPU codegen
    (clgen.nim); on TPU the XLA path is often faster than a hand schedule,
    so schedules are routed by a measured cost model and every fallback is
    reported through this category (silence with ``warnings.filterwarnings``)
    and counted in ``Model.lowering_stats``."""
