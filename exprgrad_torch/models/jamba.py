"""Jamba (Lieber et al., "Jamba: A Hybrid Transformer-Mamba Language
Model", arXiv:2403.19887; HF ``JambaForCausalLM``) written in the DSL.

Layer ``i`` of ``layers`` is ``h = x + mixer(rms(x)); out = h +
ffn(rms(h))``.  The mixer is grouped-query causal attention without any
position encoding where ``i % attn_period == attn_offset``, else a
Mamba-1 mixer (``layers.mamba``); the FFN is a top-``k`` routed SwiGLU
mixture of ``n_experts`` experts without renormalization
(``layers.moe_swiglu_ffn``) where ``i % expert_period == expert_offset``,
else one dense SwiGLU.  A final RMSNorm and an untied head (the port's
dense head, with a bias) follow.  AI21-Jamba2-Mini's period of 8 is
``[M.D, M.E, M.D, M.E, A.D, M.E, M.D, M.E]``.

Served by ``FlashLMServer``, which reads each layer's kind from the
parameters' names: the attention layers keep paged K/V and the Mamba
layers a fixed-size state a row (``ops.mamba.MambaState``).  The context
the server accepts is ``max_seq``, carried in the attention op's
attributes.  Not in ``models.__all__``, whose model functions are the
JAX package's: import it from this module.
"""

from __future__ import annotations

import math

from ..expr import iters, ln, to_scalar
from ..fun import Fun, input, make_opt, param
from ..layers import (adam, dense, fused_attention, mamba, moe_swiglu_ffn,
                      rms_norm, softmax)
from .transformer import _embed, _residual, _swiglu

__all__ = ["jamba_lm", "layer_kinds"]


def layer_kinds(layers: int, attn_period: int = 8, attn_offset: int = 4,
                expert_period: int = 2, expert_offset: int = 1) -> list:
    """``(mixer, ffn)`` of each layer: ``"attention"`` or ``"mamba"``, and
    ``"moe"`` or ``"dense"``."""
    return [("attention" if i % attn_period == attn_offset else "mamba",
             "moe" if i % expert_period == expert_offset else "dense")
            for i in range(layers)]


def _attention(x: Fun, dim: int, heads: int, kv_heads: int, max_seq: int,
               impl: str, rng) -> Fun:
    """GQA causal self-attention without positions; parameters wq, wk, wv,
    wo as ``layers.multi_head_attention``'s."""
    hd = dim // heads

    def proj(name: str, nheads: int) -> Fun:
        w = param([nheads, dim, hd], init_range=rng, name=name)
        n, h, t, c, d = iters("n", "h", "t", "c", "d")
        out = Fun(name + ".out")
        out[n, h, t, d] = x[n, t, c] * w[h, c, d]
        return out

    q, k, v = proj("wq", heads), proj("wk", kv_heads), proj("wv", kv_heads)
    att = fused_attention(q, k, v, causal=True, scale=1.0 / math.sqrt(hd),
                          impl=impl, extra_attrs={"max_seq": int(max_seq)})
    wo = param([heads, hd, dim], init_range=rng, name="wo")
    n, h, t, d, e = iters("n", "h", "t", "d", "e")
    out = Fun()
    out[n, t, e] = att[n, h, t, d] * wo[h, d, e]
    return out


def jamba_lm(
    vocab: int = 16,
    dim: int = 16,
    heads: int = 2,
    kv_heads: int = 1,
    hidden: int = 32,
    layers: int = 8,
    n_experts: int = 4,
    k: int = 2,
    attn_period: int = 8,
    attn_offset: int = 4,
    expert_period: int = 2,
    expert_offset: int = 1,
    d_state: int = 16,
    d_conv: int = 4,
    expand: int = 2,
    dt_rank: int = 0,
    eps: float = 1e-6,
    max_seq: int = 64,
    eta: float = 0.005,
    init: float = 0.02,
    impl: str = "auto",
    opt=None,
) -> Fun:
    """Jamba causal LM.  Inputs "tokens" [batch, seq] (float ids) and
    "labels" [batch, seq, vocab] (one-hot next tokens); targets "predict"
    (next-token distributions) and "train" (``opt``, by default adam at
    ``eta``).  ``hidden`` is the width of the dense FFN and of each
    expert, ``expand * dim`` the Mamba layers' ``d_inner``, ``dt_rank`` 0
    ``ceil(dim / 16)``."""
    if dim % heads or heads % kv_heads:
        raise ValueError(f"heads {heads} must divide dim {dim} and be a "
                         f"multiple of kv_heads {kv_heads}")
    rng = (-init, init)
    tokens = input("tokens")
    x = _embed(tokens, vocab, dim, max_seq, rng, pos=False)
    kinds = layer_kinds(layers, attn_period, attn_offset, expert_period,
                        expert_offset)
    for i, (mixer, ffn) in enumerate(kinds):
        rn = rms_norm(x, dim, eps=eps, rank=3)
        if mixer == "attention":
            out = _attention(rn, dim, heads, kv_heads, max_seq, impl, rng)
        else:
            out = mamba(rn, dim, expand * dim, d_state, d_conv, dt_rank,
                        eps=eps, init=init)
        x = _residual(out, x, f"layer{i}.mixer")
        rn = rms_norm(x, dim, eps=eps, rank=3)
        if ffn == "moe":
            out = moe_swiglu_ffn(rn, dim, hidden, n_experts, k, init=init)
        else:
            out = _swiglu(rn, dim, hidden, rng, lambda f: f)
        x = _residual(out, x, f"layer{i}.ffn")

    logits = dense(rms_norm(x, dim, eps=eps, rank=3), dim, vocab, rank=3)
    predict = softmax(logits, rank=3).target("predict")
    labels = input("labels")
    it = iters("it")
    loss = Fun("loss")
    loss[0] = -(labels.raw[it] * ln(predict.raw[it] + 1e-9)) / to_scalar(
        labels.shape[0] * labels.shape[1]
    )
    return (
        loss.target("loss")
        .backwards()
        .optimize(opt or make_opt(adam, eta=eta))
        .target("train")
    )
