"""Denoising diffusion (DDPM) written in the DSL.

A third generative family beside the GAN (models/gan.py) and the
autoencoder: an MLP denoiser ``eps_theta(x_t, t)`` with a sinusoidal
time embedding COMPUTED IN THE LANGUAGE (the frequency is an index
expression, like rope's angles), the forward-noising step
``x_t = sqrt(abar) x0 + sqrt(1-abar) eps`` as kernels inside the train
target, and the symbolic autodiff deriving the whole backward pass.
Host-side ancestral sampling drives the compiled "predict" target
(Ho et al., "Denoising Diffusion Probabilistic Models", 2020).

The reference has no diffusion family; this reuses its GAN seam —
``cond`` routes a computed tensor into the shared denoiser for "train"
and a runtime input for "predict" (reference parser.nim:812-817).
"""

from __future__ import annotations

import numpy as np

from ..expr import cos, irange, iters, pow_, select, sin, sqrt, to_scalar
from ..fun import Fun, cond, input_, make_opt
from ..layers import adam, dense, mse, silu


def tiny_diffusion(
    data_dim: int = 2,
    hidden: int = 64,
    emb: int = 8,
    eta: float = 2e-3,
    opt=None,
) -> Fun:
    """Targets: ``train`` (inputs ``x0``/``eps`` [b, d], ``abar``/``t``
    [b, 1]) and ``predict`` = eps_theta (inputs ``xt`` [b, d], ``t``
    [b, 1])."""
    t = input_("t")
    bb, i = iters("b", "i")

    # forward noising, in-language (train only)
    x0 = input_("x0")
    eps = input_("eps")
    abar = input_("abar")
    xt_train = Fun("xt_train")
    xt_train[bb, i] = sqrt(abar[bb, 0]) * x0[bb, i]
    bb, i = iters("b", "i")
    xt_train[bb, i] = sqrt(1.0 - abar[bb, 0]) * eps[bb, i]

    xin = cond({"train": xt_train, "loss": xt_train},
               otherwise=input_("xt"))

    # sinusoidal time embedding: freq_j = 10000^(-j/emb), sin for the
    # first half, cos for the second — the exponent is an index expr
    bb = iters("b")
    j = irange("j", 0, 2 * emb)
    te = Fun("t_emb")
    te[bb, j] = select(
        j < emb,
        sin(t[bb, 0] * pow_(10000.0, -to_scalar(j) / float(emb))),
        cos(t[bb, 0] * pow_(10000.0, -to_scalar(j - emb) / float(emb))),
    )
    # j never appears as a read index (only inside the frequency
    # expression), so the embedding width must be pinned explicitly
    te.with_shape([t.shape[0], 2 * emb])

    # concat [x_t | t_emb] by offset writes
    h = Fun("h")
    bb, i = iters("b", "i")
    h[bb, i] = xin[bb, i]
    bb = iters("b")
    j = irange("j", 0, 2 * emb)
    h[bb, j + data_dim] = te[bb, j]
    h.with_shape([xin.shape[0], data_dim + 2 * emb])

    net = (
        h.pipe(dense, data_dim + 2 * emb, hidden)
        .pipe(silu)
        .pipe(dense, hidden, hidden)
        .pipe(silu)
        .pipe(dense, hidden, data_dim)
    )
    pred = net.target("predict")
    loss = mse(pred, eps).target("loss")
    if opt is None:
        opt = make_opt(adam, eta=eta)
    return loss.backprop(opt).target("train")



def ddpm_schedule(steps: int = 50, beta_lo: float = 1e-4,
                  beta_hi: float = 0.02, ref_steps: int = 1000):
    """Linear beta schedule; returns (betas, alphas, abar) [steps].

    The (1e-4, 0.02) defaults are the paper's 1000-step schedule;
    shorter schedules scale the betas by ``ref_steps/steps`` so the
    total noise injected (``abar_T ~ 0``) stays comparable — without
    this, a 50-step run ends at ``abar ~ 0.6`` and ancestral sampling
    (which STARTS from pure noise) is off-distribution."""
    scale = ref_steps / steps
    betas = np.minimum(np.linspace(beta_lo, beta_hi, steps) * scale, 0.999)
    alphas = 1.0 - betas
    return betas, alphas, np.cumprod(alphas)


def diffusion_train_batch(x0: np.ndarray, abar: np.ndarray, rng):
    """Sample one training batch's inputs: per-sample steps, noise, and
    cumulative alphas for :func:`tiny_diffusion`'s train target."""
    b = x0.shape[0]
    steps = rng.integers(0, abar.shape[0], b)
    eps = rng.standard_normal(x0.shape)
    return {
        "x0": x0.astype(np.float32),
        "eps": eps.astype(np.float32),
        "abar": abar[steps].reshape(b, 1).astype(np.float32),
        "t": steps.reshape(b, 1).astype(np.float32),
    }


def ddpm_sample(model, n: int, data_dim: int = 2, steps: int = 50,
                seed: int = 0, schedule=None) -> np.ndarray:
    """Ancestral sampling: x_T ~ N(0, I), then for t = T-1 .. 0
    ``x <- (x - beta/sqrt(1-abar) * eps_theta(x, t)) / sqrt(alpha)
    + sigma z`` — one compiled "predict" call per step."""
    betas, alphas, abar = (
        schedule if schedule is not None else ddpm_schedule(steps)
    )
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, data_dim))
    for step in range(steps - 1, -1, -1):
        t = np.full((n, 1), step, np.float32)
        eps = np.asarray(
            model.call("predict", {"xt": x.astype(np.float32), "t": t})
        )
        x = (x - betas[step] / np.sqrt(1.0 - abar[step]) * eps) / np.sqrt(
            alphas[step]
        )
        if step > 0:
            x = x + np.sqrt(betas[step]) * rng.standard_normal(x.shape)
    return x
