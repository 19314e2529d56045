"""Mixture-of-experts FFN layer (DSL-level, symbolic-autodiff gradients).

``moe_ffn`` replaces a transformer's dense FFN with E top-k routed
expert FFNs, spliced into the kernel DSL through the extern seam
(ops/moe.py) — the same pattern as fused attention: the op's forward and
backward are whole-op externs, every surrounding kernel still lowers
through the regular compiler, and training targets derive through the
symbolic autodiff pass.

The expert-parallel execution layout (dispatching tokens over a mesh
axis) lives in ``parallel/moe.py`` and consumes the same parameter
shapes (gate [dim, E], w1 [E, dim, hidden], b1 [E, hidden],
w2 [E, hidden, dim], b2 [E, dim]).
"""

from __future__ import annotations

from ..fun import Fun, extern, extern_grads, grad, layer, param

__all__ = ["moe_ffn"]


@layer
def moe_ffn(
    x: Fun,
    dim: int,
    hidden: int,
    n_experts: int,
    k: int = 2,
    init: float = 0.1,
    prefix: str = "",
) -> Fun:
    """Top-k routed expert FFN over ``[batch, seq, dim]`` inputs.

    ``out = sum_j w_j * FFN_{e_j}(x)`` where ``e_1..e_k`` are the top-k
    experts of a learned softmax gate and ``w`` their renormalized
    probabilities (Mixtral routing).  Gradients flow to the gate through
    the routing weights and to the selected experts through the mask —
    registered as a fused extern backward, differentiable end to end.
    """
    if k < 1 or k > n_experts:
        raise ValueError(
            f"k must be in [1, n_experts={n_experts}], got {k}"
        )
    rng = (-init, init)
    gate = param([dim, n_experts], init_range=rng,
                 name=prefix + "moe.gate")
    w1 = param([n_experts, dim, hidden], init_range=rng,
               name=prefix + "moe.w1")
    b1 = param([n_experts, hidden], name=prefix + "moe.b1")
    w2 = param([n_experts, hidden, dim], init_range=rng,
               name=prefix + "moe.w2")
    b2 = param([n_experts, dim], name=prefix + "moe.b2")

    attrs = {"k": int(k)}
    out = extern("moe", [x, gate, w1, b1, w2, b2], outs=1, attrs=attrs)
    out.name = prefix + "moe"
    out.copy_shape(x)
    with out.custom_grad():
        extern_grads(
            "moe_grad",
            [x, gate, w1, b1, w2, b2, grad(out)],
            into=[grad(x), grad(gate), grad(w1), grad(b1), grad(w2),
                  grad(b2)],
            attrs=attrs,
        )
    return out
