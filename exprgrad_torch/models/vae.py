"""Variational autoencoder written in the DSL.

Completes the generative family set (GAN, DDPM, and now VAE): an
encoder producing a Gaussian posterior (mu, logvar), the
REPARAMETERIZATION trick ``z = mu + exp(logvar/2) * eps`` as a kernel
(eps is a host-sampled standard normal input, so gradients flow through
mu/logvar symbolically), a decoder, and the ELBO — reconstruction MSE
plus the analytic KL ``-0.5 * sum(1 + logvar - mu^2 - e^logvar)`` — as
one compiled loss.  ``cond`` routes the decoder's input: the sampled z
for train/loss, a runtime input for the "decode" target (sampling from
the prior), the same seam the GAN and DDPM use
(reference parser.nim:812-817; the reference has no VAE).
"""

from __future__ import annotations

import numpy as np

from ..expr import exp, iters, sq, to_scalar
from ..fun import Fun, cond, input_, make_opt
from ..layers import adam, dense, silu


def tiny_vae(
    data_dim: int = 2,
    latent: int = 2,
    hidden: int = 32,
    beta: float = 1.0,
    eta: float = 2e-3,
    opt=None,
):
    """Targets: ``train``/``loss`` (inputs ``x`` [b, d], ``eps``
    [b, latent]), ``encode`` = posterior mean (input ``x``), and
    ``decode`` (input ``z`` [b, latent])."""
    x = input_("x")
    h = x.pipe(dense, data_dim, hidden, prefix="enc.").pipe(silu)
    mu = dense(h, hidden, latent, prefix="mu.")
    logvar = dense(h, hidden, latent, prefix="logvar.")

    eps = input_("eps")
    b, j = iters("b", "j")
    z = Fun("z")
    z[b, j] = mu[b, j] + exp(0.5 * logvar[b, j]) * eps[b, j]

    zin = cond({"train": z, "loss": z}, otherwise=input_("z"))
    xhat = (
        zin.pipe(dense, latent, hidden, prefix="dec.")
        .pipe(silu)
        .pipe(dense, hidden, data_dim, prefix="out.")
    )

    # ELBO: mean squared reconstruction + beta * mean KL (both averaged
    # over the batch; KL has the analytic Gaussian form)
    b, i = iters("b", "i")
    loss = Fun("elbo")
    loss[0] = sq(xhat[b, i] - x[b, i]) / to_scalar(x.size)
    b, j = iters("b", "j")
    loss[0] = (
        -0.5 * beta
        * (1.0 + logvar[b, j] - sq(mu[b, j]) - exp(logvar[b, j]))
        / to_scalar(mu.size)
    )

    if opt is None:
        opt = make_opt(adam, eta=eta)
    train = loss.target("loss").backprop(opt).target("train")
    # decode/encode entry points share the same parameter graph
    return [train, xhat.target("decode"), mu.target("encode")]


def vae_train_batch(x: np.ndarray, latent: int, rng) -> dict:
    return {
        "x": x.astype(np.float32),
        "eps": rng.standard_normal((x.shape[0], latent)).astype(np.float32),
    }


def vae_sample(model, n: int, latent: int = 2, seed: int = 0) -> np.ndarray:
    """Decode prior samples z ~ N(0, I)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, latent)).astype(np.float32)
    return np.asarray(model.call("decode", {"z": z}))
