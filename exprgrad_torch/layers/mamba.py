"""The Mamba-1 mixer as a DSL layer (Jamba's, with its inner RMSNorms).

The scan runs as a whole-op extern (``ops/mamba.py``: the conv and scan
kernels on the card, float32 only; the sequential scan on the CPU) with
a registered backward, ``mamba_grad``, so training targets differentiate
through time via the symbolic autodiff pass, as ``layers.recurrent``'s
cells do; the backward has no kernel and runs on the CPU only.  The
state starts at zero each call.  Parameter names (``mamba.in_proj`` ..
``mamba.out_proj``, in the order of ``ops.mamba.Mixer``) are part of the
serving contract: ``FlashLMServer`` matches them.
"""

from __future__ import annotations

import math

from ..fun import Fun, extern, extern_grads, grad, layer, param

__all__ = ["mamba"]


@layer
def mamba(x: Fun, dim: int, d_inner: int, d_state: int = 16,
          d_conv: int = 4, dt_rank: int = 0, eps: float = 1e-6,
          init: float = 0.1, prefix: str = "") -> Fun:
    """Mamba-1 mixer over ``[batch, T, dim]`` -> ``[batch, T, dim]``.

    ``dt_rank`` 0 is ``ceil(dim / 16)``, Mamba's default.  The default
    ranges are a start for training: the conv and projections uniform in
    ``±init``, the inner gains and ``D`` at 1, ``a_log`` uniform in
    ``[0, ln d_state]`` and the step bias at softplus^-1 of steps in
    ``[0.01, 0.1]``."""
    rank = dt_rank or math.ceil(dim / 16)
    if min(dim, d_inner, d_state, d_conv, rank) < 1:
        raise ValueError("mamba: every size must be >= 1")
    rng = (-init, init)
    one = (1.0, 1.0)

    def p(shape, name, r=rng):
        return param(shape, init_range=r, name=f"{prefix}mamba.{name}")

    weights = [
        p([dim, 2 * d_inner], "in_proj"),
        p([d_inner, d_conv], "conv_w"),
        p([d_inner], "conv_b"),
        p([d_inner, rank + 2 * d_state], "x_proj"),
        p([rank], "dt_norm", one),
        p([d_state], "b_norm", one),
        p([d_state], "c_norm", one),
        p([rank, d_inner], "dt_proj"),
        p([d_inner], "dt_bias", (-4.6, -2.25)),
        p([d_inner, d_state], "a_log", (0.0, math.log(d_state))),
        p([d_inner], "d", one),
        p([d_inner, dim], "out_proj"),
    ]
    attrs = {"eps": float(eps)}
    out = extern("mamba", [x] + weights, attrs=attrs)
    out.name = prefix + "mamba"
    out.copy_shape(x)
    with out.custom_grad():
        extern_grads("mamba_grad", [x] + weights + [grad(out)],
                     into=[grad(x)] + [grad(w) for w in weights],
                     attrs=attrs)
    return out
