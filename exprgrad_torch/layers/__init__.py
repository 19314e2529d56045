"""Layer/optimizer/loss library, written in the DSL itself.

Like the reference (exprgrad/layers/), every layer is an ordinary DSL
kernel — the compiler derives its gradients, so user-defined layers are
first-class citizens.
"""

from .base import (
    add,
    adafactor,
    adam,
    adamw,
    binary_cross_entropy,
    clip_by_global_norm,
    clip_gradients,
    cross_entropy,
    div_scalar,
    decayed_gradient_descent,
    gradient_descent,
    huber,
    l1_loss,
    lion,
    matmul,
    maximum_elems,
    minimum_elems,
    momentum,
    mse,
    mul_scalar,
    muon,
    rmsprop,
    smoothed_cross_entropy,
    sub,
    transpose,
    with_ema,
)
from .attention import (
    fused_attention,
    multi_head_attention,
    multi_head_cross_attention,
    rope,
)
from .schedules import (
    cosine_decay,
    exponential_decay,
    step_decay,
    warmup,
    warmup_cosine,
)
from .dnn import (
    avgpool2,
    conv2,
    dense,
    depthwise_conv2,
    dropout,
    layer_norm,
    leaky_relu,
    lora_dense,
    maxpool2,
    merge_lora,
    relu,
    rms_norm,
    sigmoid,
    silu,
    sin_layer,
    softmax,
    tanh,
    upsample2,
)
from .mamba import mamba
from .moe import moe_ffn, moe_swiglu_ffn
from .recurrent import gru, lstm, rnn_tanh

__all__ = [
    "gru", "lstm", "rnn_tanh",
    "adafactor", "adam", "adamw", "add", "avgpool2", "binary_cross_entropy", "conv2",
    "cross_entropy", "decayed_gradient_descent", "dense", "depthwise_conv2",
    "div_scalar",
    "dropout", "fused_attention", "gradient_descent", "huber",
    "l1_loss", "lion",
    "mamba", "moe_ffn", "moe_swiglu_ffn",
    "momentum", "multi_head_attention", "multi_head_cross_attention",
    "rope",
    "leaky_relu", "lora_dense", "matmul", "maximum_elems", "maxpool2",
    "merge_lora", "minimum_elems",
    "layer_norm",
    "mse", "mul_scalar", "muon", "relu", "rms_norm", "rmsprop", "sigmoid",
    "silu", "sin_layer", "smoothed_cross_entropy", "softmax", "sub",
    "tanh", "transpose", "upsample2",
    "clip_by_global_norm", "clip_gradients",
    "cosine_decay", "exponential_decay", "step_decay", "warmup",
    "warmup_cosine", "with_ema",
]
