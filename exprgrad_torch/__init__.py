"""exprgrad-torch: the exprgrad DSL on PyTorch and CUDA.

The port of ``exprgrad_tpu`` to one NVIDIA GPU.  The front end — the DSL,
IR, passes and layer library — is shared with the JAX package and
re-exported here; below the IR this package lowers kernels to torch
operations and runs hand-written CUDA kernels where the JAX package ran
Pallas kernels.  It never imports jax.

Quick start::

    import exprgrad_torch as egt
    from exprgrad_torch.models import flash_transformer

    model = egt.compile(flash_transformer(), seed=0, device="cuda")
    model.fit("train", {"tokens": tokens, "labels": labels}, batch_size=8)
    probs = model.call("predict", {"tokens": tokens})

Checkpoints: ``exprgrad_torch.io``; the training driver:
``exprgrad_torch.train``.
"""

from exprgrad_tpu.errors import (
    ExprgradError,
    GradientError,
    GeneratorError,
    KernelTypeError,
    ModelRuntimeError,
    ParserError,
    RematWarning,
    ScheduleWarning,
    ShapeError,
    StageError,
    ValidationError,
)
from exprgrad_tpu.expr import (
    Boolean,
    Index,
    Scalar,
    array,
    cos,
    debug_index,
    debug_scalar,
    epoch,
    exp,
    irange,
    iters,
    ln,
    log,
    log2,
    log10,
    maximum,
    minimum,
    pow_,
    select,
    sin,
    sq,
    sqrt,
    to_index,
    to_scalar,
    wrap,
)
from exprgrad_tpu.fun import (
    Fun,
    cache,
    cond,
    extern,
    extern_grads,
    grad,
    input,
    input_,
    layer,
    make_opt,
    param,
    rand,
    to_program,
)

from . import models
from .model import Model, compile, from_reference
from .registry import register_extern

__all__ = [
    "Boolean", "Index", "Scalar", "Fun", "Model", "array", "cache",
    "compile", "cond", "cos", "debug_index", "debug_scalar", "epoch", "exp",
    "extern", "extern_grads", "from_reference", "grad", "input", "input_",
    "irange", "iters", "layer", "ln", "log", "log10", "log2", "make_opt",
    "maximum", "minimum", "models", "param", "pow_", "rand",
    "register_extern", "select", "sin", "sq", "sqrt", "to_index",
    "to_program", "to_scalar", "wrap",
    "ExprgradError", "GradientError", "GeneratorError", "KernelTypeError",
    "ModelRuntimeError", "ParserError", "RematWarning", "ScheduleWarning",
    "ShapeError", "StageError", "ValidationError",
]
