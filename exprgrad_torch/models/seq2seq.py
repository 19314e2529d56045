"""Encoder-decoder (seq2seq) model family.

Beyond the reference's model families and the decoder-only transformers
here: a full encoder-decoder built from the layer library — bidirectional
self-attention over the source, causal self-attention plus
CROSS-ATTENTION (``layers.multi_head_cross_attention``, fused extern
kernels) in the decoder.  The canonical correctness task is sequence
reversal: producing position ``i`` requires attending to source position
``s-1-i``, which only cross-attention can do, so a model that trains to
zero loss proves the seam end to end (tests/test_seq2seq.py).

Inputs: "src" [batch, s] and "tgt" [batch, t] float ids (tgt is the
shifted target prefix for teacher forcing), "labels" [batch, t, vocab]
one-hot.  Targets: "predict" and "train".
"""

from __future__ import annotations

from ..expr import iters, ln, maximum, to_scalar
from ..fun import Fun, input, make_opt
from ..layers import (
    adam,
    dense,
    multi_head_attention,
    multi_head_cross_attention,
    relu,
    rms_norm,
    softmax,
)
from .transformer import _embed, _residual

__all__ = ["greedy_decode", "tiny_seq2seq"]


def greedy_decode(model, src, n_new: int, bos: int = 0):
    """Autoregressive greedy decoding through the compiled model's
    "predict" target: feed the growing target prefix (starting at
    ``bos``) and take the argmax of the last position each step.

    O(t^2) in total (each step re-runs the full teacher-forced forward)
    but exact and backend-agnostic — the production fast path is
    :class:`~exprgrad_torch.models.Seq2SeqServer` (encode once + KV
    cache, per-token cost independent of t, greedy token-equal to this).
    The model's parameters may be tensors on any device.
    Returns [batch, n_new] int token ids.
    """
    import numpy as np

    from ..errors import ModelRuntimeError

    # the target prefix grows to n_new+1 positions; they must fit the
    # model's tgt positional table or the embedding read goes OOB
    max_tgt = next(
        (model.params[tid].shape[0]
         for tid in model.program.params
         if model.program.tensors[tid].name == "tgt.pos"),
        None,
    )
    if max_tgt is not None and n_new + 1 > max_tgt:
        raise ModelRuntimeError(
            f"n_new + 1 = {n_new + 1} exceeds the model's max_tgt "
            f"{max_tgt} positional embeddings"
        )
    src = np.asarray(src, np.float32)
    batch = src.shape[0]
    tgt = np.full((batch, 1), float(bos), np.float32)
    out = []
    for _ in range(n_new):
        probs = np.asarray(model.call("predict", {"src": src, "tgt": tgt}))
        nxt = probs[:, -1].argmax(-1)
        out.append(nxt)
        tgt = np.concatenate([tgt, nxt[:, None].astype(np.float32)], axis=1)
    return np.stack(out, axis=1)


def tiny_seq2seq(
    vocab: int = 8,
    dim: int = 16,
    heads: int = 2,
    hidden: int = 32,
    max_src: int = 32,
    max_tgt: int = 32,
    enc_blocks: int = 1,
    dec_blocks: int = 1,
    eta: float = 0.01,
    init: float = 0.2,
    impl: str = "auto",
    opt=None,
) -> Fun:
    """``enc_blocks`` bidirectional encoder blocks + ``dec_blocks``
    decoder blocks (causal self + cross attention) + FFN, pre-norm
    residual throughout."""
    rng = (-init, init)

    # every parameter is name-prefixed per block ("enc0.att.wq", ...):
    # the graph interleaves encoder and decoder parameter registration
    # (lazy construction), so serving extracts weights by unique NAME,
    # not traversal order (models/seq2seq_serve.py Seq2SeqServer)
    src = input("src")
    e = _embed(src, vocab, dim, max_src, rng, "src")
    for b in range(enc_blocks):
        p = f"enc{b}."
        enc_att = multi_head_attention(
            rms_norm(e, dim, rank=3, prefix=p + "att."), dim, heads,
            causal=False, impl=impl, prefix=p + "att.",
        )
        e = _residual(enc_att, e, p + "att")
        enc_ff = dense(
            relu(dense(rms_norm(e, dim, rank=3, prefix=p + "ffn."), dim,
                       hidden, rank=3, prefix=p + "ffn1.")),
            hidden, dim, rank=3, prefix=p + "ffn2.",
        )
        e = _residual(enc_ff, e, p + "out")
    enc = e

    # --- decoder ---------------------------------------------------------
    tgt = input("tgt")
    x = _embed(tgt, vocab, dim, max_tgt, rng, "tgt")
    for b in range(dec_blocks):
        p = f"dec{b}."
        self_att = multi_head_attention(
            rms_norm(x, dim, rank=3, prefix=p + "self."), dim, heads,
            causal=True, impl=impl, prefix=p + "self.",
        )
        x = _residual(self_att, x, p + "self")
        cross = multi_head_cross_attention(
            rms_norm(x, dim, rank=3, prefix=p + "cross."), enc, dim,
            heads, impl=impl, prefix=p + "cross.",
        )
        x = _residual(cross, x, p + "cross")
        ff = dense(
            relu(dense(rms_norm(x, dim, rank=3, prefix=p + "ffn."), dim,
                       hidden, rank=3, prefix=p + "ffn1.")),
            hidden, dim, rank=3, prefix=p + "ffn2.",
        )
        x = _residual(ff, x, p + "out")

    logits = dense(rms_norm(x, dim, rank=3, prefix="head."), dim, vocab,
                   rank=3, prefix="head.")
    predict = softmax(logits, rank=3).target("predict")

    labels = input("labels")
    it = iters("it")
    loss = Fun("loss")
    loss[0] = -(labels.raw[it] * ln(maximum(predict.raw[it], 1e-9))) / \
        to_scalar(labels.shape[0] * labels.shape[1])
    return (
        loss.target("loss")
        .backwards()
        .optimize(opt or make_opt(adam, eta=eta))
        .target("train")
    )
