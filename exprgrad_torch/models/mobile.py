"""Depthwise-separable CNN (MobileNet-style blocks) in the kernel DSL.

Each block = depthwise 3x3 conv (per-channel spatial filter) + pointwise
1x1 conv (channel mixing) + leaky relu — Howard et al. 2017.  Exercises
the grouped-convolution lowering end to end: every forward and derived
gradient kernel of the depthwise stage compiles to a grouped
``lax.conv_general_dilated`` (convmatch.py feature groups), the pointwise
stage to MXU einsums.  Beyond the reference's model zoo (its CNN is plain
conv+pool, examples/fashion_mnist/fashion_mnist.nim).
"""

from __future__ import annotations

from ..fun import Fun, input, make_opt
from ..layers import (
    adam,
    avgpool2,
    cross_entropy,
    dense,
    depthwise_conv2,
    conv2,
    leaky_relu,
    maxpool2,
    softmax,
)

__all__ = ["mobile_cnn"]


def _separable_block(x: Fun, cin: int, cout: int) -> Fun:
    x = depthwise_conv2(x, cin, 3, 3)
    x = leaky_relu(x)
    x = conv2(x, cin, 1, 1, cout)   # pointwise 1x1
    return leaky_relu(x)


def mobile_cnn(classes: int = 10, eta: float = 0.01) -> Fun:
    """Inputs: "x" [batch, 28, 28]; "y" one-hot [batch, classes].
    Targets: "predict", "loss", "fit"."""
    net = (
        input("x")
        .reshape([-1, 28, 28, 1])
        .pipe(conv2, 1, 3, 3, 8)        # stem: 28 -> 26
        .pipe(leaky_relu)
        .pipe(maxpool2)                  # 26 -> 13
        .pipe(_separable_block, 8, 16)   # 13 -> 11
        .pipe(maxpool2)                  # 11 -> 5 (floor)
        .pipe(_separable_block, 16, 32)  # 5 -> 3
        .pipe(avgpool2)                  # 3 -> 1
        .reshape([-1, 32])
        .pipe(dense, 32, classes)
        .pipe(softmax)
        .target("predict")
        .pipe(cross_entropy, input("y"))
        .target("loss")
        .backwards()
        .optimize(make_opt(adam, eta=eta))
        .target("fit")
    )
    return net
