"""Port parity: the flash_transformer predict target end to end.

The port model is built from the JAX model with ``from_reference`` (same
parameters) and both run "predict" on the same tokens.  Tolerance
``rtol=1e-4, atol=1e-5`` on the next-token probabilities, the bound the
JAX package's serving tests use (tests/test_serve.py).
"""

import numpy as np
import pytest

import exprgrad_torch as egt
from exprgrad_tpu import compile
from exprgrad_tpu.models import flash_transformer

VOCAB = 16
TOL = dict(rtol=1e-4, atol=1e-5)

CONFIGS = {
    "mha": dict(),
    "mqa": dict(kv_heads=1),
    "gqa_window": dict(kv_heads=2, window=8),
    "rope": dict(rope=True),
    "swiglu_tied": dict(ffn="swiglu", tie_embeddings=True, rope=True),
}


def _tokens(seed, n=2, t=48):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (n, t)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predict_matches_jax(name):
    graph = flash_transformer(vocab=VOCAB, dim=32, heads=4, hidden=32,
                              blocks=2, max_seq=64, **CONFIGS[name])
    ref = compile(graph, backend="jax", seed=0)
    port = egt.from_reference(ref, device="cpu")
    toks = _tokens(len(name))
    got = port.call("predict", {"tokens": toks})
    want = ref.call("predict", {"tokens": toks})
    assert got.shape == (2, 48, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)
    stats = port.lowering_stats("predict")
    assert stats["attention-impl:flash"] == 2
    assert stats["extern:attention"] == 2


def test_predict_matches_interp_and_seeded_compile():
    """``compile(seed=...)`` draws the same parameters as the JAX package,
    and the port agrees with the numpy oracle too."""
    graph = flash_transformer(vocab=VOCAB, dim=16, heads=2, blocks=1)
    port = egt.compile(graph, seed=3, device="cpu")
    oracle = compile(graph, backend="interp", seed=3)
    for tid, value in oracle.params.items():
        np.testing.assert_array_equal(port.params[tid].numpy(), value)
    toks = _tokens(5, t=16)
    np.testing.assert_allclose(port.call("predict", {"tokens": toks}),
                               oracle.call("predict", {"tokens": toks}),
                               **TOL)


def test_xla_impl_matches_jax():
    """impl="xla" runs the plain-attention path on both sides."""
    graph = flash_transformer(vocab=VOCAB, dim=16, heads=2, blocks=1,
                              impl="xla")
    ref = compile(graph, backend="jax", seed=1)
    port = egt.from_reference(ref, device="cpu")
    toks = _tokens(6, t=24)
    np.testing.assert_allclose(port.call("predict", {"tokens": toks}),
                               ref.call("predict", {"tokens": toks}), **TOL)
    assert port.lowering_stats("predict")["attention-impl:xla"] == 1


def test_ragged_length_runs_flash_where_jax_runs_xla():
    """A sequence above 128 that is no multiple of it misses the TPU
    kernels' block rule, so the JAX package attends through plain XLA;
    the port's ``auto`` takes the flash path and agrees."""
    graph = flash_transformer(vocab=VOCAB, dim=16, heads=2, blocks=1,
                              max_seq=160)
    ref = compile(graph, backend="jax", seed=2)
    port = egt.from_reference(ref, device="cpu")
    toks = _tokens(8, n=1, t=136)
    np.testing.assert_allclose(port.call("predict", {"tokens": toks}),
                               ref.call("predict", {"tokens": toks}), **TOL)
    assert port.lowering_stats("predict")["attention-impl:flash"] == 1
    assert ref.lowering_stats("predict")["attention-impl:xla"] == 1


def test_training_through_attention_is_not_ported_yet():
    graph = flash_transformer(vocab=VOCAB, dim=16, heads=2, blocks=1)
    port = egt.compile(graph, seed=0, device="cpu")
    toks = _tokens(7, t=8)
    labels = np.eye(VOCAB, dtype=np.float32)[toks.astype(int)]
    with pytest.raises(NotImplementedError, match="attention_grad"):
        port.apply("train", {"tokens": toks, "labels": labels})
