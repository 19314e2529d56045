"""Recurrent language models: LSTM/GRU/RNN sequence models in the DSL.

The recurrent family the reference never had (layers top out at
conv/dense, reference layers/dnn.nim): embedding lookups are
data-dependent reads with scatter-add gradients (like tiny_transformer),
the recurrence itself is the ``lax.scan`` extern (layers.lstm/gru/
rnn_tanh) with registered BPTT, and the head/loss/update kernels derive
through symbolic autodiff — the whole train target still compiles into
one XLA program.
"""

from __future__ import annotations

from ..expr import iters, ln, to_index, to_scalar
from ..fun import Fun, input, make_opt, param
from ..layers import adam, dense, gru, lstm, rnn_tanh, softmax

__all__ = ["tiny_recurrent_lm"]

_CELLS = {"lstm": lstm, "gru": gru, "rnn": rnn_tanh}


def tiny_recurrent_lm(
    vocab: int = 16,
    dim: int = 16,
    hidden: int = 32,
    cell: str = "lstm",
    layers: int = 1,
    eta: float = 0.01,
    init: float = 0.2,
) -> Fun:
    """Next-token recurrent LM.  Inputs: "tokens" [batch, seq] (float
    ids), "labels" [batch, seq, vocab] one-hot next tokens.  Targets:
    "predict" (distributions) / "loss" / "train"."""
    if cell not in _CELLS:
        raise ValueError(
            f"cell must be one of {sorted(_CELLS)}, got {cell!r}")
    if layers < 1:
        raise ValueError(f"layers must be >= 1 (got {layers})")
    cell_fn = _CELLS[cell]
    rng = (-init, init)
    tokens = input("tokens")

    n, t, d = iters("n", "t", "d")
    x = Fun("x")
    emb = param([vocab, dim], init_range=rng, name="embed")
    x[n, t, d] = emb[to_index(tokens[n, t]), d]
    x.with_shape([tokens.shape[0], tokens.shape[1], dim])

    h = x
    width = dim
    for li in range(layers):
        h = cell_fn(h, width, hidden, init=init, prefix=f"l{li}.")
        width = hidden

    logits = dense(h, hidden, vocab, rank=3, prefix="head.")
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
        .optimize(make_opt(adam, eta=eta))
        .target("train")
    )
