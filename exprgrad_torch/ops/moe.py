"""Mixture-of-experts FFN as an extern op (forward + backward).

The port's counterpart of ``exprgrad_tpu/ops/moe.py``: ``layers.moe_ffn``
splices ``moe`` into a model through the extern seam, and symbolic
autodiff calls ``moe_grad``.  Routing (Mixtral-style top-k):

    probs   = softmax(x @ gate)                  # [n, t, E]
    idx     = top-k experts per token            # ties -> lowest index
    weight  = probs[idx] / sum_k probs[idx]      # renormalized
    out     = sum_j weight_j * FFN_{idx_j}(x)    # FFN = relu(x W1+b1) W2+b2

As in the JAX package, every expert is computed densely and the results
are combined through the routing mask: exact semantics, and every product
is one batched matmul (cuBLAS on the card; no Pallas kernel is involved).
The top k come from ``torch.sort(descending=True, stable=True)``, which
keeps equal probabilities in expert order, the tie rule of
``jax.lax.top_k``; ``torch.topk`` promises no order for ties.  The
backward is ``torch.autograd.grad`` of the same forward, the vjp the JAX
package takes with ``jax.vjp``.

Precision: float32 and bfloat16 programs compute in float32, as the JAX
implementation does; a float64 program computes in float64 (the JAX
implementation computes float64 programs in float32, its numpy oracle in
float64).
"""

from __future__ import annotations

import torch

from ..registry import register_extern


def _k_of(attrs: dict) -> int:
    k = int(attrs.get("k", 1))
    if k < 1:
        raise ValueError(f"moe k must be >= 1, got {k}")
    return k


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 for a float64 program, float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def routing(x, gate, k: int):
    """(probs, idx, weight, mask) of the top-k routing, in ``x``'s dtype."""
    probs = torch.softmax(torch.einsum("ntc,ce->nte", x, gate), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    vals = vals[..., :k]
    weight = vals / vals.sum(dim=-1, keepdim=True)
    mask = torch.zeros_like(probs).scatter(-1, idx, weight)
    return probs, idx, weight, mask


def moe_forward(x, gate, w1, b1, w2, b2, k: int):
    """The MoE layer's output ``[n, t, d]`` in ``x``'s dtype."""
    ct = compute_dtype(x.dtype)
    xf, gate, w1, b1, w2, b2 = (a.to(ct) for a in (x, gate, w1, b1, w2, b2))
    _, _, _, mask = routing(xf, gate, k)
    h = torch.relu(torch.einsum("ntc,ech->nteh", xf, w1) + b1)
    y = torch.einsum("nteh,ehd->nted", h, w2) + b2
    return torch.einsum("nte,nted->ntd", mask, y).to(x.dtype)


def _moe(args, attrs, ctx):
    x, gate, w1, b1, w2, b2 = args
    return moe_forward(x, gate, w1, b1, w2, b2, _k_of(attrs))


def _moe_grad(args, attrs, ctx):
    *inputs, g = args
    k = _k_of(attrs)
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in inputs]
        out = moe_forward(*leaves, k)
        grads = torch.autograd.grad(out, leaves, g.to(out.dtype),
                                    allow_unused=True)
    return tuple(torch.zeros_like(a) if d is None else d.to(a.dtype)
                 for a, d in zip(inputs, grads))


register_extern("moe", 1, _moe)
register_extern("moe_grad", 6, _moe_grad)
