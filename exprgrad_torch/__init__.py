"""exprgrad-torch: the exprgrad DSL on PyTorch and CUDA.

The port of ``exprgrad_tpu`` to one NVIDIA GPU.  The front end — the DSL
(``fun.py``, ``expr.py``), the IR (``ir.py``, ``irprint.py``), ``passes/``,
``layers/``, the numpy oracle ``interp.py`` and the DSL model builders —
is this package's own copy of the JAX package's, at the same relative
paths; below the IR this package lowers kernels to torch operations and
runs hand-written CUDA kernels where the JAX package ran Pallas kernels.
It imports neither jax nor the JAX package.

Quick start::

    import exprgrad_torch as egt
    from exprgrad_torch.models import flash_transformer

    model = egt.compile(flash_transformer(), seed=0, device="cuda")
    model.fit("train", {"tokens": tokens, "labels": labels}, batch_size=8)
    probs = model.call("predict", {"tokens": tokens})

Checkpoints, checkpoint rotation and dataset iteration:
``exprgrad_torch.io``; the multi-epoch training loop: :func:`train`.
"""

from .errors import (
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
from .expr import (
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
from .fun import (
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
from .model import Model, compile, from_state, load_compiled
from .quant import QuantW, dequantize, quantize_weight
from .registry import register_extern
from .train import classification_accuracy, evaluate, train
from .autotune import TuneReport
from .tensor import (
    Tensor,
    concat_first,
    one_hot,
    remap,
    select_random_samples,
    select_samples,
    shuffle_xy,
    squares,
    view_first,
)

__all__ = [
    "Boolean", "Index", "Scalar", "Fun", "Model", "Tensor", "TuneReport",
    "array", "cache",
    "classification_accuracy", "compile", "concat_first", "cond", "cos",
    "debug_index", "debug_scalar", "epoch", "evaluate", "exp",
    "extern", "extern_grads", "from_state", "grad", "input", "input_",
    "irange", "iters", "layer", "ln", "load_compiled", "log", "log10",
    "log2", "make_opt",
    "maximum", "minimum", "models", "one_hot", "param", "pow_", "rand",
    "register_extern", "remap", "select", "select_random_samples",
    "select_samples", "shuffle_xy", "sin", "sq", "sqrt", "squares",
    "to_index", "to_program", "to_scalar", "train", "view_first", "wrap",
    "ExprgradError", "GradientError", "GeneratorError", "KernelTypeError",
    "ModelRuntimeError", "ParserError", "RematWarning", "ScheduleWarning",
    "ShapeError", "StageError", "ValidationError", "QuantW", "dequantize",
    "quantize_weight",
]
