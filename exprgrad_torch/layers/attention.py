"""Attention layers: fused flash attention as a DSL building block.

The bridge the reference cannot express: its layer library tops out at
conv/dense (dnn.nim:19-100) and its only escape hatch is hand-written DSL
gradient kernels (customGrad, parser.nim:568-589).  Here a whole fused op
— the Pallas flash-attention forward and backward kernels
(ops/attention.py) — is spliced into the symbolic-autodiff graph through
the extern seam (fun.extern/extern_grads), so user models written in the
kernel DSL get memory-linear fused attention *with gradients* while every
surrounding kernel (projections, residuals, norms) still lowers through
the regular compiler.

Head split/merge is expressed as per-head projection contractions
("ntc,hcd->nhtd" einsums) rather than reshape+transpose — pure-iterator
kernels that the backend lowers straight to MXU einsums with zero
gathers.
"""

from __future__ import annotations

import math
from typing import Optional

from ..expr import iters
from ..fun import Fun, extern, extern_grads, grad, layer, param


def fused_attention(
    q: Fun,
    k: Fun,
    v: Fun,
    causal: bool = False,
    scale: float = 0.0,
    impl: str = "auto",
    window: Optional[int] = None,
    extra_attrs: Optional[dict] = None,
) -> Fun:
    """Fused scaled-dot-product attention over ``[batch, heads, seq, dim]``.

    ``k``/``v`` may carry fewer heads than ``q`` (grouped-query/multi-query
    attention) as long as their head count divides ``q``'s.  ``scale <= 0``
    means 1/sqrt(head_dim).  ``impl``: "flash" (Pallas kernels), "xla"
    (plain einsum attention), or "auto" (per-shape cost-model routing —
    see backend/policy.py attention()).  ``window`` (with ``causal=True``)
    restricts each query to the last ``window`` positions — sliding-window
    attention, O(S*W) on the flash path via whole-tile skipping.

    Differentiable: the backward pass is registered through the
    custom_grad seam and runs the fused flash backward kernels (or the
    XLA formula, same routing).
    """
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(
            f"impl must be 'auto', 'flash' or 'xla', got {impl!r}"
        )
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    attrs = {"causal": bool(causal), "scale": float(scale), "impl": impl,
             "window": int(window or 0)}
    if extra_attrs:
        attrs.update(extra_attrs)  # model metadata (e.g. rope base)
    out, lse = extern("attention", [q, k, v], outs=2, attrs=attrs)
    out.name = "attention"
    lse.name = "attention.lse"
    out.copy_shape(q)
    lse.with_shape([q.shape[0] * q.shape[1], q.shape[2]])
    with out.custom_grad():
        extern_grads(
            "attention_grad",
            [q, k, v, out, lse, grad(out)],
            into=[grad(q), grad(k), grad(v)],
            attrs=attrs,
        )
    return out


def rope(x: Fun, head_dim: int, base: float = 10000.0) -> Fun:
    """Rotary position embedding over ``[batch, heads, seq, head_dim]``
    (rotate-half convention: RoFormer / GPT-NeoX / LLaMA).

    Pure DSL kernels — the rotation angle is an *index expression*
    (``t * base^(-2d/hd)`` via exp/ln of iterator scalars), so the whole
    thing lowers like any other kernel and the symbolic autodiff derives
    the backward rotation automatically (cos/sin derivative rules +
    offset-read gradient kernels).  Two kernels write the two halves:

        out[..., d]      = x[..., d]      * cos(a) - x[..., d+h/2] * sin(a)
        out[..., d+h/2]  = x[..., d+h/2]  * cos(a) + x[..., d]      * sin(a)

    Applied to q and k after projection; the dot product then depends
    only on relative position.  (Beyond the reference — its layers stop
    at dense/conv; this is the modern-LM position encoding.)
    """
    from ..expr import cos, exp, irange, sin, to_scalar

    half = head_dim // 2
    if half * 2 != head_dim or half < 1:
        raise ValueError(f"rope needs an even head_dim >= 2 ({head_dim})")
    coef = -2.0 * math.log(base) / head_dim

    out = Fun("rope")
    n, h, t = iters("n", "h", "t")
    d = irange("d", 0, half)
    ang = to_scalar(t) * exp(to_scalar(d) * coef)
    out[n, h, t, d] = (
        x[n, h, t, d] * cos(ang) - x[n, h, t, d + half] * sin(ang)
    )
    n, h, t = iters("n", "h", "t")
    d = irange("d", 0, half)
    ang = to_scalar(t) * exp(to_scalar(d) * coef)
    out[n, h, t, d + half] = (
        x[n, h, t, d + half] * cos(ang) + x[n, h, t, d] * sin(ang)
    )
    out.copy_shape(x)
    return out


def _mha_core(
    x: Fun,
    context: Fun,
    dim: int,
    context_dim: int,
    heads: int,
    causal: bool,
    kv_heads: Optional[int],
    impl: str,
    init: float,
    window: Optional[int],
    prefix: str = "",
    rope_base: Optional[float] = None,
    rope_max_seq: int = 0,
) -> Fun:
    """Shared projections + fused core for self- and cross-attention.
    Parameter names (wq/wk/wv/wo, optionally namespaced by ``prefix``)
    and kernel structure are part of the serving contract (FlashLMServer
    matches the unprefixed sequence; Seq2SeqServer extracts prefixed
    names) — keep stable."""
    if dim % heads:
        raise ValueError(f"dim ({dim}) must be divisible by heads ({heads})")
    kvh = heads if kv_heads is None else kv_heads
    if heads % kvh:
        raise ValueError(
            f"heads ({heads}) must be a multiple of kv_heads ({kvh})"
        )
    hd = dim // heads
    rng = (-init, init)

    def proj(src: Fun, name: str, nheads: int, in_dim: int) -> Fun:
        w = param([nheads, in_dim, hd], init_range=rng, name=prefix + name)
        n, h, t, c, d = iters("n", "h", "t", "c", "d")
        out = Fun(name + ".out")
        out[n, h, t, d] = src[n, t, c] * w[h, c, d]
        return out

    q = proj(x, "wq", heads, dim)
    k = proj(context, "wk", kvh, context_dim)
    v = proj(context, "wv", kvh, context_dim)
    extra = None
    if rope_base:
        q = rope(q, hd, rope_base)
        k = rope(k, hd, rope_base)
        # metadata for the serving runtimes (discovered like ``window``)
        extra = {"rope": float(rope_base),
                 "rope_max_seq": int(rope_max_seq)}

    att = fused_attention(
        q, k, v, causal=causal, scale=1.0 / math.sqrt(hd), impl=impl,
        window=window, extra_attrs=extra,
    )

    wo = param([heads, hd, dim], init_range=rng, name=prefix + "wo")
    n, h, t, d, e = iters("n", "h", "t", "d", "e")
    out = Fun()
    out[n, t, e] = att[n, h, t, d] * wo[h, d, e]
    return out


@layer
def multi_head_attention(
    x: Fun,
    dim: int,
    heads: int,
    causal: bool = True,
    kv_heads: Optional[int] = None,
    impl: str = "auto",
    init: float = 0.1,
    window: Optional[int] = None,
    prefix: str = "",
    rope_base: Optional[float] = None,
    rope_max_seq: int = 0,
) -> Fun:
    """Multi-head self-attention over ``[batch, seq, dim]`` inputs.

    Projections are per-head contractions (q = "ntc,hcd->nhtd" einsums on
    the MXU, no reshapes/gathers); the attention core is
    :func:`fused_attention`; the output projection merges heads the same
    way ("nhtd,hde->nte").  ``kv_heads`` (dividing ``heads``) enables
    grouped-query attention with a smaller KV projection.
    """
    return _mha_core(x, x, dim, dim, heads, causal, kv_heads, impl, init,
                     window, prefix, rope_base=rope_base,
                     rope_max_seq=rope_max_seq)


@layer
def multi_head_cross_attention(
    x: Fun,
    context: Fun,
    dim: int,
    heads: int,
    context_dim: Optional[int] = None,
    kv_heads: Optional[int] = None,
    impl: str = "auto",
    init: float = 0.1,
    prefix: str = "",
) -> Fun:
    """Cross-attention: queries from ``x`` [batch, t, dim], keys/values
    from ``context`` [batch, s, context_dim] (defaults to ``dim``) — the
    encoder-decoder building block.  Same per-head contraction
    projections and fused-attention core as
    :func:`multi_head_attention`; non-causal (every query sees the whole
    context), and the fused kernels handle ``t != s`` natively.
    """
    return _mha_core(x, context, dim, context_dim or dim, heads, False,
                     kv_heads, impl, init, None, prefix)
