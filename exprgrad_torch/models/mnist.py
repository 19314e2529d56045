"""Fashion-MNIST CNN classifier (the flagship benchmark model).

Parity: reference examples/fashion_mnist/fashion_mnist.nim:41-57 —
conv(5x5x8) -> leakyRelu -> maxpool2 -> conv(3x3x16) -> leakyRelu ->
maxpool2 -> dense(400,10) -> softmax, crossEntropy loss, adam(0.01).
"""

from __future__ import annotations

from ..fun import Fun, input, make_opt
from ..layers import (
    adam,
    conv2,
    cross_entropy,
    dense,
    leaky_relu,
    maxpool2,
    softmax,
)


def fashion_mnist_cnn(eta: float = 0.01) -> Fun:
    return (
        input("x")
        .reshape([-1, 28, 28, 1])
        .pipe(conv2, 1, 5, 5, 8)
        .pipe(leaky_relu)
        .pipe(maxpool2)
        .pipe(conv2, 8, 3, 3, 16)
        .pipe(leaky_relu)
        .pipe(maxpool2)
        .reshape([-1, 16 * 5 * 5])
        .pipe(dense, 16 * 5 * 5, 10)
        .pipe(softmax)
        .target("predict")
        .pipe(cross_entropy, input("y"))
        .target("loss")
        .backwards()
        .optimize(make_opt(adam, eta=eta))
        .target("fit")
    )
