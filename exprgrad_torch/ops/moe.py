"""Mixture-of-experts FFNs as extern ops (forward + backward): ``moe``,
the JAX package's relu experts, and ``moe_swiglu``, Jamba's SwiGLU
experts (the second half of this module).

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
from .matmul import weight_product


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


# --- SwiGLU experts, top-k without renormalization (Jamba's layer) -------
#
#     probs = softmax(x @ router)            # [tokens, E]
#     idx   = top-k experts per token        # ties -> lowest index
#     out   = sum_j probs[idx_j] * W2_e(silu(W1_e x) * (W3_e x))
#
# with bias-free experts wg (W1), wu (W3) [E, dim, hidden] and wd (W2)
# [E, hidden, dim].  Two evaluations of the same sum: ``swiglu_routed``
# sorts the token-expert pairs by expert and runs each expert once, on
# the tokens routed to it (the DSL op and the server's prefill); and
# ``swiglu_dense_masked`` runs every expert on every row and weighs them
# by the routing mask, whose shapes do not depend on the routing (the
# server's decode step inside a CUDA graph).  Both compute in the
# inputs' dtype; their weight products go through
# ``ops.matmul.weight_product`` (the weight-streaming kernel where an
# expert sees at most 32 rows).


def route_top(x, router, k: int):
    """(experts [tokens, k], their probabilities [tokens, k]) of ``x``
    [tokens, dim], by a stable descending sort (ties to the lowest
    index) and without renormalization."""
    probs = torch.softmax(x @ router, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order[:, :k], vals[:, :k]


def swiglu(x, wg, wu, wd):
    """One bias-free SwiGLU: ``(silu(x @ wg) * (x @ wu)) @ wd`` (each
    product by ``ops.matmul.weight_product``)."""
    g = weight_product(x, wg)
    return weight_product(g / (1.0 + torch.exp(-g)) * weight_product(x, wu),
                          wd)


def swiglu_routed(x, router, wg, wu, wd, k: int):
    """The layer's output for ``x`` [tokens, dim]: each expert computed
    only on the tokens routed to it (one read of the counts to the
    host)."""
    idx, weight = route_top(x, router, k)
    experts = idx.reshape(-1)
    order = torch.argsort(experts, stable=True)
    token = order // k
    counts = torch.bincount(experts, minlength=wg.shape[0]).tolist()
    out = torch.zeros_like(x)
    start = 0
    for e, count in enumerate(counts):
        if count:
            pick = order[start:start + count]
            rows = token[start:start + count]
            y = swiglu(x[rows], wg[e], wu[e], wd[e])
            out = out.index_add(0, rows, y * weight.reshape(-1)[pick, None])
        start += count
    return out


def swiglu_dense_masked(x, router, wg, wu, wd, k: int):
    """The same output with every expert computed on every row of ``x``
    [rows, dim] and weighed by the routing mask (0 off the top k): the
    shapes are fixed, so a CUDA graph can capture it."""
    idx, weight = route_top(x, router, k)
    mask = torch.zeros((x.shape[0], wg.shape[0]), dtype=x.dtype,
                       device=x.device).scatter(1, idx, weight)
    g = weight_product(x, wg)                         # [E, rows, hidden]
    h = g / (1.0 + torch.exp(-g)) * weight_product(x, wu)
    return torch.einsum("re,erd->rd", mask, weight_product(h, wd))


def _moe_swiglu(args, attrs, ctx):
    x, router, wg, wu, wd = args
    ct = compute_dtype(x.dtype)
    flat = x.reshape(-1, x.shape[-1]).to(ct)
    out = swiglu_routed(flat, *(w.to(ct) for w in (router, wg, wu, wd)),
                        _k_of(attrs))
    return out.reshape(x.shape).to(x.dtype)


def _moe_swiglu_grad(args, attrs, ctx):
    *inputs, g = args
    ct = compute_dtype(inputs[0].dtype)
    with torch.enable_grad():
        leaves = [a.detach().to(ct).requires_grad_(True) for a in inputs]
        x = leaves[0]
        out = swiglu_routed(x.reshape(-1, x.shape[-1]), *leaves[1:],
                            _k_of(attrs))
        grads = torch.autograd.grad(out, leaves,
                                    g.to(ct).reshape(out.shape),
                                    allow_unused=True)
    return tuple(torch.zeros_like(a) if d is None else d.to(a.dtype)
                 for a, d in zip(inputs, grads))


register_extern("moe_swiglu", 1, _moe_swiglu)
register_extern("moe_swiglu_grad", 5, _moe_swiglu_grad)
