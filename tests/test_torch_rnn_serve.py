"""Port parity: stateful serving of recurrent LMs
(exprgrad_torch/models/rnn_serve.py).

tests/test_rnn_serve.py's sizes, run on the port beside the JAX
package's RecurrentServer on the same weights (tiny_recurrent_lm trained
five steps by the JAX package, carried over with ``egt.from_state``):

* greedy ``generate`` equals the argmax chain of the port's "predict"
  target recomputed from scratch each step, and the JAX server's tokens,
  for lstm, gru (two layers) and tanh cells;
* sampling: the same seed gives the same tokens, and the first draw's
  frequencies over many rows follow the softmax of the last logits
  (``jax.random`` streams cannot be reproduced);
* the refusals raise the same error types.
"""

import functools

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_tpu as eg
import exprgrad_tpu.models as jm
from exprgrad_torch.errors import ModelRuntimeError
from exprgrad_torch.models import (RecurrentServer, tiny_recurrent_lm,
                                   tiny_transformer)

VOCAB = 12


@functools.lru_cache(maxsize=None)
def _trained(cell="lstm", layers=1, seed=0):
    """(JAX model, port model) with the same weights."""
    kw = dict(vocab=VOCAB, dim=10, hidden=14, cell=cell, layers=layers,
              eta=0.02)
    ref = eg.compile(jm.tiny_recurrent_lm(**kw), backend="jax", seed=seed)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (4, 9)).astype(np.float32)
    labels = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (4, 9))]
    for _ in range(5):
        ref.epoch += 1
        ref.apply("train", {"tokens": toks, "labels": labels})
    port = egt.from_state(tiny_recurrent_lm(**kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")
    return ref, port


def _greedy_oracle(model, prompt, n_new):
    toks = [list(map(int, row)) for row in prompt]
    for _ in range(n_new):
        probs = model.call("predict", {"tokens": np.asarray(toks,
                                                            np.float32)})
        for r in range(len(toks)):
            toks[r].append(int(probs[r, -1].argmax()))
    return np.asarray([row[prompt.shape[1]:] for row in toks])


@pytest.mark.parametrize("cell,layers", [("lstm", 1), ("gru", 2),
                                         ("rnn", 1)])
def test_greedy_matches_predict_chain_and_jax(cell, layers):
    ref, port = _trained(cell, layers)
    srv = RecurrentServer(port)
    assert [lay.cell for lay in srv.layers] == \
        [{"rnn": "rnn_tanh"}.get(cell, cell)] * layers
    prompt = np.random.default_rng(3).integers(0, VOCAB, (3, 5))
    got = srv.generate(prompt, n_new=7)
    assert got.dtype == torch.int32 and got.device == port.device
    np.testing.assert_array_equal(got.numpy(),
                                  _greedy_oracle(port, prompt, 7))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.RecurrentServer(ref).generate(prompt,
                                                                 7)))


def test_sampling_is_seeded_and_follows_the_softmax():
    _, port = _trained()
    srv = RecurrentServer(port)
    prompt = np.zeros((2, 3), np.int32)
    a = srv.generate(prompt, n_new=6, temperature=0.8, seed=4)
    b = srv.generate(prompt, n_new=6, temperature=0.8, seed=4)
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB
    rows = np.repeat(prompt[:1], 4000, axis=0)
    first = srv.generate(rows, n_new=1, temperature=1.0, seed=9)[:, 0]
    probs = port.call("predict", {"tokens": prompt[:1].astype(np.float32)})
    freq = np.bincount(first.numpy(), minlength=VOCAB) / first.numel()
    assert np.abs(freq - probs[0, -1]).max() < 0.03, (freq, probs[0, -1])


def test_refusals_match_jax():
    ref, port = _trained()
    jtr = eg.compile(jm.tiny_transformer(vocab=6, dim=8), backend="jax",
                     seed=0)
    ttr = egt.compile(tiny_transformer(vocab=6, dim=8), seed=0,
                      device="cpu")
    with pytest.raises(eg.ModelRuntimeError, match="tiny_recurrent_lm"):
        jm.RecurrentServer(jtr)
    with pytest.raises(ModelRuntimeError, match="tiny_recurrent_lm"):
        RecurrentServer(ttr)
    for srv, err in ((jm.RecurrentServer(ref), eg.ModelRuntimeError),
                     (RecurrentServer(port), ModelRuntimeError)):
        with pytest.raises(err, match="n_new"):
            srv.generate(np.zeros((1, 2), np.int32), n_new=0)
        with pytest.raises(err, match="prompt"):
            srv.generate(np.zeros((3,), np.int32), n_new=2)
        with pytest.raises(err, match="prompt"):
            srv.generate(np.zeros((3, 0), np.int32), n_new=2)
