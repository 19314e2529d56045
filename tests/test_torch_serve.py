"""Port parity: FlashLMServer KV-cache serving (exprgrad_torch/models/serve.py).

The server's torch forward must reproduce the compiled predict target
(prefill probabilities within ``rtol=1e-4, atol=1e-5``, the JAX package's
serving bound), token-by-token decoding must reproduce prefill, and
greedy generation must equal the JAX package's FlashLMServer token for
token on the same trained weights.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import exprgrad_torch as egt
from exprgrad_tpu import ModelRuntimeError, compile
from exprgrad_tpu.models import flash_transformer
from exprgrad_tpu.models.serve import FlashLMServer as JaxServer
from exprgrad_torch.models import FlashLMServer
from exprgrad_torch.models._sample import check_top_p, make_picker

VOCAB = 8
TOL = dict(rtol=1e-4, atol=1e-5)


def _cycle_data(n=16, t=8):
    rng = np.random.default_rng(0)
    phase = rng.integers(0, VOCAB, n)
    toks = ((phase[:, None] + np.arange(t)[None, :]) % VOCAB).astype(
        np.float32)
    labels = np.eye(VOCAB, dtype=np.float32)[((toks + 1) % VOCAB).astype(int)]
    return toks, labels


def _trained(steps=30, **kw):
    """A JAX model briefly trained on the +1 cycle, and its port twin."""
    ref = compile(flash_transformer(vocab=VOCAB, dim=16, heads=2, eta=0.01,
                                    **kw), backend="jax", seed=0)
    toks, labels = _cycle_data()
    for _ in range(steps):
        ref.epoch += 1
        ref.apply("train", {"tokens": toks, "labels": labels})
    return ref, egt.from_reference(ref, device="cpu")


def _softmax(logits):
    return torch.softmax(logits, dim=-1).numpy()


@pytest.mark.parametrize("kw", [dict(), dict(kv_heads=1),
                                dict(rope=True, window=4)],
                         ids=["mha", "mqa", "rope_window"])
def test_prefill_matches_predict(kw):
    port = egt.compile(flash_transformer(vocab=VOCAB, dim=16, heads=2,
                                         blocks=2, **kw),
                       seed=1, device="cpu")
    server = FlashLMServer(port, cache_dtype=torch.float32)
    toks = np.random.default_rng(1).integers(0, VOCAB, (3, 12)).astype(
        np.float32)
    logits, caches = server.prefill(toks, server.init_caches(3))
    assert caches[0].length == 12
    np.testing.assert_allclose(_softmax(logits),
                               port.call("predict", {"tokens": toks}), **TOL)


def test_incremental_decode_matches_prefill():
    port = egt.compile(flash_transformer(vocab=VOCAB, dim=16, heads=2,
                                         kv_heads=1, window=5),
                       seed=2, device="cpu")
    server = FlashLMServer(port, cache_dtype=torch.float32)
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 10)).astype(
        np.float32)
    full, _ = server.prefill(toks, server.init_caches(2))
    caches = server.init_caches(2)
    steps = []
    for t in range(10):
        logits, caches = server.decode(toks[:, t:t + 1], caches)
        steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               **TOL)


def test_decode_consumes_caches_and_clones_branch():
    """prefill/decode write K/V into the caches they are given (the JAX
    package's caches are functional); a branch decoded from clones is
    independent and matches prefill of its own tokens."""
    port = egt.compile(flash_transformer(vocab=VOCAB, dim=16, heads=2),
                       seed=4, device="cpu")
    server = FlashLMServer(port, cache_dtype=torch.float32)
    toks = np.random.default_rng(4).integers(0, VOCAB, (2, 6)).astype(
        np.float32)
    _, caches = server.prefill(toks, server.init_caches(2))
    branch = [c._replace(k=c.k.clone(), v=c.v.clone()) for c in caches]
    before = caches[0].k.clone()
    a = np.full((2, 1), 1.0, np.float32)
    b = np.full((2, 1), 5.0, np.float32)
    _, after = server.decode(a, caches)
    assert after[0].k.data_ptr() == caches[0].k.data_ptr()
    assert caches[0].length == 6 and after[0].length == 7
    assert not torch.equal(caches[0].k[:, :, 6], before[:, :, 6])
    torch.testing.assert_close(branch[0].k, before, rtol=0, atol=0)
    got, _ = server.decode(b, branch)
    full, _ = server.prefill(np.concatenate([toks, b], axis=1),
                             server.init_caches(2))
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(), **TOL)


def test_greedy_generate_matches_jax_server():
    ref, port = _trained()
    prompt = np.asarray([[2.0, 3.0, 4.0], [5.0, 6.0, 7.0]], np.float32)
    want = np.asarray(JaxServer(ref, cache_dtype=jnp.float32).generate(
        prompt, n_new=9))
    got = FlashLMServer(port, cache_dtype=torch.float32).generate(
        prompt, n_new=9)
    assert got.dtype == torch.float32 and got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    # the model learned the +1 cycle, so the comparison is not vacuous
    np.testing.assert_array_equal(got.numpy()[:, :3],
                                  (prompt[:, -1:] + [1, 2, 3]) % VOCAB)


def test_top_k_one_sampling_is_greedy_and_seeded():
    _, port = _trained(steps=5)
    server = FlashLMServer(port)  # bfloat16 cache, the default
    prompt = np.random.default_rng(3).integers(0, VOCAB, (4, 5)).astype(
        np.float32)
    greedy = server.generate(prompt, n_new=6)
    sampled = server.generate(prompt, n_new=6, temperature=0.7, top_k=1,
                              seed=11)
    np.testing.assert_array_equal(sampled.numpy(), greedy.numpy())
    a = server.generate(prompt, n_new=6, temperature=1.5, top_p=0.9, seed=4)
    b = server.generate(prompt, n_new=6, temperature=1.5, top_p=0.9, seed=4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ((a >= 0) & (a < VOCAB)).all()


def test_stop_token_freezes_rows():
    _, port = _trained()
    server = FlashLMServer(port, cache_dtype=torch.float32)
    prompt = np.asarray([[0.0, 1.0, 2.0], [4.0, 5.0, 6.0]], np.float32)
    free = server.generate(prompt, n_new=8).numpy()
    stop = int(free[0, 2])
    got = server.generate(prompt, n_new=8, stop_token=stop).numpy()
    for row, out in zip(free, got):
        hits = np.flatnonzero(row == stop)
        if hits.size:
            first = hits[0]
            np.testing.assert_array_equal(out[:first + 1], row[:first + 1])
            assert np.all(out[first:] == stop)
        else:
            np.testing.assert_array_equal(out, row)


def test_picker_filters_match_jax_semantics():
    """top-k then nucleus: only the surviving tokens are ever drawn."""
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0, -1.0]] * 64)
    gen = torch.Generator().manual_seed(0)
    drawn = make_picker(6, 1.0, 3, None)(logits, gen)
    assert set(drawn.tolist()) <= {0, 1, 2}
    probs = torch.softmax(logits[0], 0)
    # smallest prefix whose mass reaches 0.9
    keep = int((torch.cumsum(probs, 0) - probs < 0.9).sum())
    drawn = make_picker(6, 1.0, None, 0.9)(logits, gen)
    assert set(drawn.tolist()) <= set(range(keep))
    assert make_picker(6, 0.0, None, None)(logits, gen).tolist() == [0] * 64
    with pytest.raises(ModelRuntimeError, match="top_p"):
        check_top_p(1.5)


def test_server_rejects_foreign_models_and_overflow():
    from exprgrad_tpu.models import tiny_mixer

    with pytest.raises(ModelRuntimeError, match="flash_transformer"):
        FlashLMServer(egt.compile(list(tiny_mixer()), seed=0, device="cpu"))
    port = egt.compile(flash_transformer(vocab=VOCAB, dim=8, heads=2),
                       seed=0, device="cpu")
    server = FlashLMServer(port)
    prompt = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    with pytest.raises(ModelRuntimeError, match="capacity"):
        server.generate(prompt, n_new=4, capacity=5)
    with pytest.raises(ModelRuntimeError, match="max_seq"):
        server.generate(prompt, n_new=63)
    with pytest.raises(ModelRuntimeError, match="n_new"):
        server.generate(prompt, n_new=0)
    assert server.generate(prompt, n_new=4, capacity=6).shape == (1, 4)
