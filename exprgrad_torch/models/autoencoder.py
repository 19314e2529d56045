"""Convolutional autoencoder: conv/pool encoder, upsample decoder.

Exercises the full round trip of the pooling/upsampling operators in
training: maxpool2's custom gradient, upsample2's window-sum derived
gradient (the scatter-free reshape+sum lowering), and conv gradients on
both sides of the bottleneck.
"""

from __future__ import annotations

from ..fun import Fun, input, make_opt
from ..layers import adam, conv2, leaky_relu, maxpool2, mse, sigmoid, upsample2


def conv_autoencoder(size: int = 28, eta: float = 0.005) -> Fun:
    """Input "x" [batch, size, size]; targets "encode", "decode", "train".

    Spatial sizes: conv 3x3 shrinks by 2, pool halves; upsample doubles,
    then a final conv refines.  With size=28: 28 -> 26 -> 13 (bottleneck)
    -> 26 -> 24 output; the loss compares against the matching center crop.
    """
    inner = size - 2
    half = inner // 2
    out_size = 2 * half - 2

    encoded = (
        input("x")
        .reshape([-1, size, size, 1])
        .pipe(conv2, 1, 3, 3, 8)
        .pipe(leaky_relu)
        .pipe(maxpool2)
        .target("encode")
    )
    decoded = (
        encoded
        .pipe(upsample2)
        .pipe(conv2, 8, 3, 3, 1)
        .pipe(sigmoid)
        .target("decode")
    )

    # compare against the center crop of the input (valid convs shrink)
    from ..expr import irange, iters

    x = input("x")
    offset = (size - out_size) // 2
    n, c = iters("n", "c")
    y = irange("y", 0, out_size)
    xx = irange("xx", 0, out_size)
    target_img = Fun("crop")
    target_img[n, y, xx, c] = x[n, y + offset, xx + offset]
    target_img.with_shape([x.shape[0], out_size, out_size, 1])

    return (
        decoded.pipe(mse, target_img)
        .target("loss")
        .backwards()
        .optimize(make_opt(adam, eta=eta))
        .target("train")
    )
