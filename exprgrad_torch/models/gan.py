"""MNIST GAN: generator + discriminator with per-target routing.

Parity: reference examples/gan/gan.nim — the discriminator input is a
``cond`` node that reads generated samples for generator-training targets
and real samples otherwise; the two optimizers update disjoint parameter
sets (generator params are excluded from the discriminator update).
"""

from __future__ import annotations

from ..expr import iters, sq, to_scalar
from ..fun import Fun, cond, input, make_opt
from ..layers import dense, gradient_descent, leaky_relu, mse, sigmoid


def _gen_loss(labels: Fun) -> Fun:
    """Generator wants discriminator outputs near 0 (labels are the
    discriminator scores for generated samples)."""
    it = iters("it")
    out = Fun("gen_loss")
    out[0] = sq(labels.raw[it]) / to_scalar(labels.shape[0])
    return out


def mnist_gan(
    latent: int = 32, image_size: int = 28 * 28, rate: float = 0.1
) -> list[Fun]:
    gen = (
        input("seed")
        .pipe(dense, latent, 64)
        .pipe(leaky_relu, 0.01)
        .pipe(dense, 64, 128)
        .pipe(leaky_relu, 0.01)
        .pipe(dense, 128, image_size)
        .pipe(sigmoid)
        .target("gen")
    )
    discr = (
        cond({"fit.gen": gen, "loss.gen": gen}, otherwise=input("samples"))
        .pipe(dense, image_size, 128)
        .pipe(leaky_relu, 0.01)
        .pipe(dense, 128, 64)
        .pipe(leaky_relu, 0.01)
        .pipe(dense, 64, 1)
        .pipe(sigmoid)
        .target("discr")
    )
    gen_params = gen.params()
    fit_gen = (
        _gen_loss(discr)
        .target("loss.gen")
        .backwards()
        .optimize(make_opt(gradient_descent, rate=rate), params=gen_params)
        .target("fit.gen")
    )
    discr_only = [p for p in discr.params() if p not in gen_params]
    fit_discr = (
        discr.pipe(mse, input("labels"))
        .target("loss.discr")
        .backwards()
        .optimize(make_opt(gradient_descent, rate=rate), params=discr_only)
        .target("fit.discr")
    )
    return [gen, discr, fit_gen, fit_discr]
