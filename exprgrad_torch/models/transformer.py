"""A tiny causal transformer written entirely in the kernel DSL.

Beyond the reference's model families (MLP/CNN/GAN/raytracer): demonstrates
that the language + symbolic autodiff cover modern architectures —
embedding lookups are data-dependent tensor reads (with scatter-add
gradients into the table), causal masking is an index comparison inside
``select``, attention score/value contractions lower to MXU einsums, and
the whole forward + derived backward + adam update still compiles into one
XLA program.
"""

from __future__ import annotations

import math

from ..expr import exp, iters, select, to_index, to_scalar
from ..fun import Fun, input, make_opt, param
from ..layers import adam

__all__ = ["tiny_transformer", "flash_transformer"]


def _softmax_last(logits: Fun, vocab: int = 0) -> Fun:
    """Exact max-shifted softmax over the last of 3 dims (true
    max-reduction via the maximize accumulation extension)."""
    n, t, v = iters("n", "t", "v")
    row_max = Fun("softmax.max")
    row_max.maximize[n, t] = logits[n, t, v]
    n, t, v = iters("n", "t", "v")
    sums = Fun("softmax.sums")
    sums[n, t] = exp(logits[n, t, v] - row_max[n, t])
    n, t, v = iters("n", "t", "v")
    out = Fun("softmax")
    out[n, t, v] = exp(logits[n, t, v] - row_max[n, t]) / sums[n, t]
    return out


def tiny_transformer(
    vocab: int = 8,
    dim: int = 16,
    hidden: int = 32,
    eta: float = 0.005,
    init: float = 0.2,
) -> Fun:
    """Single-block causal LM.  Inputs: "tokens" [batch, seq] (float ids),
    "labels" [batch, seq, vocab] one-hot next tokens.  Targets: "predict"
    (next-token distributions) and "train"."""
    rng = (-init, init)
    tokens = input("tokens")

    # embeddings: token table + learned positions
    n, t, d = iters("n", "t", "d")
    x = Fun("x")
    emb = param([vocab, dim], init_range=rng, name="embed")
    x[n, t, d] = emb[to_index(tokens[n, t]), d]
    # positions: the table covers max_seq=64 rows but only seq are used, so
    # the iterator needs explicit bounds (like the reference's bounded
    # ``(x in a..<b)`` iterators) and x's shape must be declared
    from ..expr import irange

    n, d = iters("n", "d")
    t = irange("t", 0, tokens.shape[1])
    pos = param([64, dim], init_range=rng, name="pos")  # max seq 64
    x[n, t, d] = pos[t, d]
    x.with_shape([tokens.shape[0], tokens.shape[1], dim])

    # single-head self attention
    def proj(name: str) -> Fun:
        w = param([dim, dim], init_range=rng, name=name)
        n, t, d, k = iters("n", "t", "d", "k")
        out = Fun(name + ".out")
        out[n, t, d] = x[n, t, k] * w[k, d]
        return out

    q, k_, v_ = proj("wq"), proj("wk"), proj("wv")

    n, a, b, d = iters("n", "a", "b", "d")
    scores = Fun("scores")
    scores[n, a, b] = q[n, a, d] * k_[n, b, d] * (1.0 / math.sqrt(dim))

    # causal masked softmax over b, max-shifted for stability
    n, a, b = iters("n", "a", "b")
    score_max = Fun("scores.max")
    score_max.maximize[n, a] = select(b <= a, scores[n, a, b], -1e30)
    n, a, b = iters("n", "a", "b")
    masked = Fun("masked")
    masked[n, a, b] = select(
        b <= a, exp(scores[n, a, b] - score_max[n, a]), 0.0
    )
    n, a, b = iters("n", "a", "b")
    denom = Fun("denom")
    denom[n, a] = masked[n, a, b]
    n, a, b = iters("n", "a", "b")
    probs = Fun("attn")
    probs[n, a, b] = masked[n, a, b] / denom[n, a]

    n, a, b, d = iters("n", "a", "b", "d")
    attended = Fun("attended")
    attended[n, a, d] = probs[n, a, b] * v_[n, b, d]

    # residual + 2-layer MLP with relu
    n, t, d = iters("n", "t", "d")
    h = Fun("h")
    h[n, t, d] = attended[n, t, d] + x[n, t, d]

    w1 = param([dim, hidden], init_range=rng, name="w1")
    n, t, j, d = iters("n", "t", "j", "d")
    ff1 = Fun("ff1")
    ff1[n, t, j] = h[n, t, d] * w1[d, j]
    it = iters("it")
    ff1r = Fun("ff1r")
    ff1r.raw[it] = select(ff1.raw[it] >= 0.0, ff1.raw[it], 0.0)

    w2 = param([hidden, dim], init_range=rng, name="w2")
    n, t, j, d = iters("n", "t", "j", "d")
    ff2 = Fun("ff2")
    ff2[n, t, d] = ff1r[n, t, j] * w2[j, d]
    n, t, d = iters("n", "t", "d")
    res2 = Fun("res2")
    res2[n, t, d] = ff2[n, t, d] + h[n, t, d]

    # output head + softmax
    wout = param([dim, vocab], init_range=rng, name="wout")
    n, t, d, c = iters("n", "t", "d", "c")
    logits = Fun("logits")
    logits[n, t, c] = res2[n, t, d] * wout[d, c]
    predict = _softmax_last(logits).target("predict")

    # cross entropy against one-hot labels
    labels = input("labels")
    from ..expr import ln

    it = iters("it")
    loss = Fun("loss")
    loss[0] = -(labels.raw[it] * ln(predict.raw[it] + 1e-9)) / to_scalar(
        labels.shape[0] * labels.shape[1]
    )
    return (
        loss.target("loss")
        .backwards()
        .optimize(make_opt(adam, eta=eta))
        .target("train")
    )


def _embed(tokens: Fun, vocab: int, dim: int, max_seq: int, rng,
           prefix: str = "", emb: Fun = None, pos: bool = True) -> Fun:
    """Token + learned-position embeddings (gather + bounded-iterator add).

    The default parameter names "embed"/"pos" are part of the serving
    contract (FlashLMServer matches them); ``prefix`` namespaces them for
    models with several embeddings (seq2seq encoder/decoder).  ``emb``
    passes in an existing embedding parameter (weight tying).
    """
    from ..expr import irange

    dot = prefix + "." if prefix else ""
    n, t, d = iters("n", "t", "d")
    x = Fun(dot + "x")
    if emb is None:
        emb = param([vocab, dim], init_range=rng, name=dot + "embed")
    x[n, t, d] = emb[to_index(tokens[n, t]), d]
    if pos:  # rotary models carry positions in the attention rotation
        n, d = iters("n", "d")
        t = irange("t", 0, tokens.shape[1])
        pos_p = param([max_seq, dim], init_range=rng, name=dot + "pos")
        x[n, t, d] = pos_p[t, d]
    x.with_shape([tokens.shape[0], tokens.shape[1], dim])
    return x


def _swiglu(x: Fun, dim: int, hidden: int, rng, marked) -> Fun:
    """Gated SwiGLU FFN: ``(silu(x @ wg) * (x @ wu)) @ wd`` with
    silu(a) = a * sigmoid(a) = a / (1 + exp(-a)) written in scalar DSL
    ops (exp/division), so the backward pass is derived symbolically.
    Parameter names ffn.wg/ffn.wu/ffn.wd are part of the serving
    contract (FlashLMServer discovers the gated block by them)."""
    from ..expr import exp

    wg = param([dim, hidden], init_range=rng, name="ffn.wg")
    wu = param([dim, hidden], init_range=rng, name="ffn.wu")
    wd = param([hidden, dim], init_range=rng, name="ffn.wd")
    n, t, c, j = iters("n", "t", "c", "j")
    g = Fun("ffn.gate")
    g[n, t, j] = x[n, t, c] * wg[c, j]
    n, t, c, j = iters("n", "t", "c", "j")
    u = Fun("ffn.up")
    u[n, t, j] = x[n, t, c] * wu[c, j]
    n, t, j = iters("n", "t", "j")
    h = Fun("ffn.h")
    gv = g[n, t, j]
    h[n, t, j] = gv / (1.0 + exp(-gv)) * u[n, t, j]
    h = marked(h)
    n, t, j, d = iters("n", "t", "j", "d")
    out = Fun("ffn.down")
    out[n, t, d] = h[n, t, j] * wd[j, d]
    return out


def _residual(a: Fun, b: Fun, name: str) -> Fun:
    n, t, d = iters("n", "t", "d")
    out = Fun(name)
    out[n, t, d] = a[n, t, d]
    n, t, d = iters("n", "t", "d")
    out[n, t, d] = b[n, t, d]  # second kernel accumulates
    return out


def flash_transformer(
    vocab: int = 8,
    dim: int = 16,
    heads: int = 2,
    hidden: int = 32,
    blocks: int = 1,
    max_seq: int = 64,
    kv_heads=None,
    eta: float = 0.005,
    init: float = 0.2,
    impl: str = "auto",
    remat: bool = False,
    opt=None,
    window=None,
    moe_experts: int = 0,
    moe_k: int = 2,
    tie_embeddings: bool = False,
    rope: bool = False,
    rope_base: float = 10000.0,
    ffn: str = "relu",
) -> Fun:
    """Pre-norm causal LM built from the rank-polymorphic layer library —
    the flagship DSL transformer.  ``opt`` overrides the default
    ``make_opt(adam, eta=eta)`` with any bound optimizer (e.g.
    ``clip_by_global_norm(make_opt(adamw, eta=warmup_cosine(...)), 1.0)``).
    ``window`` gives every block sliding-window attention (each position
    attends to the previous ``window`` tokens only; FlashLMServer
    discovers and honors it when serving).

    Each block is ``x += mha(rms_norm(x)); x += ffn(rms_norm(x))`` with
    :func:`exprgrad_torch.layers.multi_head_attention` (fused flash/XLA
    attention through the extern custom-grad seam — the attention weight
    matrix never hits HBM on the flash path) and rank-3 ``rms_norm`` /
    ``dense`` applied without any manual reshapes.  Same interface as
    :func:`tiny_transformer`: inputs "tokens" [batch, seq] and "labels"
    [batch, seq, vocab]; targets "predict" and "train".

    ``remat=True`` marks the per-block normalized activations and the FFN
    hidden (the largest cheap activations) for recompute-in-backward —
    gradient kernels read CSE-fenced recomputed copies instead of keeping
    the forward values alive across the whole backward pass.

    ``moe_experts > 0`` replaces every block's dense FFN with a top-
    ``moe_k`` routed mixture-of-experts FFN (``layers.moe_ffn``, extern
    forward+backward — the sparse-FFN LM family).

    ``rope=True`` replaces the learned position table with rotary
    position embeddings (rotate-half, applied to q/k after projection —
    layers.attention.rope): relative-position attention, no pos
    parameter, and FlashLMServer rotates by absolute cache position when
    serving.  ``max_seq`` stays the declared serving context cap.

    ``ffn="swiglu"`` swaps the relu MLP for the gated SwiGLU block
    (LLaMA recipe, no FFN biases): ``down((gate * sigmoid(gate)) * up)``
    with three matrices ffn.wg/ffn.wu/ffn.wd — silu is expressed in
    scalar DSL ops, so the gradient through the gate falls out of the
    symbolic autodiff.  ``rope=True, ffn="swiglu", tie_embeddings=True``
    together give the full modern-LM block (rms_norm is already the
    default norm).

    ``tie_embeddings=True`` shares ONE parameter between the input
    embedding table and the LM head (``logits = h @ embed.T``, the
    GPT-2/Gemma recipe, saving vocab x dim weights): the same tensor is
    read by a gather kernel and a matmul kernel, and the symbolic
    autodiff accumulates both gradient paths into it — one scatter-add
    from the lookup, one dense contribution from the head.
    """
    from ..expr import ln
    from ..layers import (
        dense, moe_ffn, multi_head_attention, relu, rms_norm, softmax,
    )

    rng = (-init, init)
    tokens = input("tokens")
    emb = (
        param([vocab, dim], init_range=rng, name="embed")
        if tie_embeddings else None
    )
    x = _embed(tokens, vocab, dim, max_seq, rng, emb=emb, pos=not rope)

    def marked(fun: Fun) -> Fun:
        return fun.remat() if remat else fun

    for b in range(blocks):
        att = multi_head_attention(
            marked(rms_norm(x, dim, rank=3)), dim, heads, causal=True,
            kv_heads=kv_heads, impl=impl, window=window,
            rope_base=rope_base if rope else None,
            rope_max_seq=max_seq if rope else 0,
        )
        x = _residual(att, x, f"blk{b}.att")
        if moe_experts > 0:
            ff = moe_ffn(
                marked(rms_norm(x, dim, rank=3)), dim, hidden,
                n_experts=moe_experts, k=moe_k, init=init,
                prefix=f"blk{b}.",
            )
        elif ffn == "swiglu":
            ff = _swiglu(marked(rms_norm(x, dim, rank=3)), dim, hidden,
                         rng, marked)
        elif ffn == "relu":
            ff = dense(
                marked(relu(marked(dense(
                    marked(rms_norm(x, dim, rank=3)), dim, hidden, rank=3
                )))),
                hidden, dim, rank=3,
            )
        else:
            raise ValueError(
                f"ffn must be 'relu' or 'swiglu', got {ffn!r}"
            )
        x = _residual(ff, x, f"blk{b}.ff")

    h = rms_norm(x, dim, rank=3)
    if tie_embeddings:
        # head = embed.T plus a bias: logits[n,t,v] = h[n,t,d]*emb[v,d]
        n, t, v, d = iters("n", "t", "v", "d")
        logits = Fun("head")
        logits[n, t, v] = h[n, t, d] * emb[v, d]
        n, t, v = iters("n", "t", "v")
        head_b = param([vocab], init_range=rng, name="bias")
        logits[n, t, v] = head_b[v]  # second kernel accumulates
    else:
        logits = dense(h, dim, vocab, rank=3)
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
