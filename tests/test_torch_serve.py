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
import exprgrad_tpu.models as jax_models
from exprgrad_tpu import compile
from exprgrad_tpu.models.serve import FlashLMServer as JaxServer
from exprgrad_torch import ModelRuntimeError
from exprgrad_torch.models import FlashLMServer, flash_transformer
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
    """A JAX model briefly trained on the +1 cycle, and its port twin: the
    same program built with the port's builder, carrying the JAX model's
    state."""
    kw = dict(vocab=VOCAB, dim=16, heads=2, eta=0.01, **kw)
    ref = compile(jax_models.flash_transformer(**kw), backend="jax", seed=0)
    toks, labels = _cycle_data()
    for _ in range(steps):
        ref.epoch += 1
        ref.apply("train", {"tokens": toks, "labels": labels})
    return ref, egt.from_state(flash_transformer(**kw), ref.params,
                               ref.caches, ref.epoch,
                               ref._rng.bit_generator.state, device="cpu")


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


def test_decode_consumes_caches_and_clones_branch(monkeypatch):
    """Caches are functional, as the JAX package's: two branches decoded
    from one cache equal the JAX server's two branches, the first
    branch's caches keep their values after the second is decoded, and
    only the branch copies the storage (copy on write): the linear path
    writes in place and generation loops clone nothing."""
    from exprgrad_torch.ops import decode as port_decode

    ref, port = _trained(steps=5)
    jsrv = JaxServer(ref, cache_dtype=jnp.float32)
    server = FlashLMServer(port, cache_dtype=torch.float32)
    clones = []
    real_own = port_decode._own
    monkeypatch.setattr(port_decode, "_own",
                        lambda c: clones.append(1) or real_own(c))
    toks = np.random.default_rng(4).integers(0, VOCAB, (2, 6)).astype(
        np.float32)
    a = np.full((2, 1), 1.0, np.float32)
    b = np.full((2, 1), 5.0, np.float32)
    _, jc = jsrv.prefill(toks, jsrv.init_caches(2))
    ja, _ = jsrv.decode(a, jc)
    jb, _ = jsrv.decode(b, jc)

    _, caches = server.prefill(toks, server.init_caches(2))
    got_a, after = server.decode(a, caches)
    assert after[0].k.data_ptr() == caches[0].k.data_ptr()  # in place
    assert not clones
    kept = [(c.k.clone(), c.v.clone(), c.length) for c in after]
    got_b, branch = server.decode(b, caches)
    assert len(clones) == len(caches)  # one copy a block, for the branch
    assert branch[0].k.data_ptr() != after[0].k.data_ptr()
    for c, (k, v, length) in zip(after, kept):
        assert c.length == length == 7
        assert torch.equal(c.k, k) and torch.equal(c.v, v)
    assert caches[0].length == 6
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(jb), **TOL)
    # the first branch decodes on from its caches as if b never ran
    got_a2, _ = server.decode(b, after)
    ja2, _ = jsrv.decode(b, jsrv.decode(a, jc)[1])
    np.testing.assert_allclose(got_a2.numpy(), np.asarray(ja2), **TOL)

    clones.clear()
    server.generate(toks[:, :3], n_new=5)
    server.generate_speculative(server, toks[:1, :3], n_new=6, k=2)
    server.generate_beam(toks[:1, :3], n_new=4, beams=2)
    assert not clones


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
    from exprgrad_torch.models import tiny_mixer

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


# --- mesh serving (tests/test_serve.py's mesh cases) -------------------------

def test_mesh_tensor_parallel_serving(tmp_path):
    """Serving on a 2 x 2 mesh of gloo ranks: head-sharded attention (the
    flash kernel's plain version on the local heads in prefill), column/
    row-sharded FFN, vocab-sharded head, data-split batches -- greedy
    output equal to the one-device servers of both packages, score
    within 1e-5, and int8 weights sharded codes and scales alike."""
    from test_torch_parallel import _jax_state, _w_serve
    from test_torch_spawn import run_world

    ref, port = _trained()
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, VOCAB, (4, 8)).astype(np.float32)
    want = np.asarray(JaxServer(ref).generate(prompt, n_new=12))
    solo = FlashLMServer(port)
    np.testing.assert_array_equal(solo.generate(prompt, n_new=12).numpy(),
                                  want)
    nll = solo.score(prompt).numpy()
    q_want = FlashLMServer(port, weight_dtype=torch.int8).generate(
        prompt, n_new=12).numpy()
    kw = dict(vocab=VOCAB, dim=16, heads=2, eta=0.01)
    calls = [("generate", (prompt,), {"n_new": 12}), ("score", (prompt,), {})]
    res = run_world(tmp_path, _w_serve, 4, (2, 2), "flash_transformer", kw,
                    _jax_state(ref), {}, calls)
    q_res = run_world(tmp_path, _w_serve, 2, (1, 2), "flash_transformer",
                      kw, _jax_state(ref), {"weight_dtype": "int8"},
                      calls[:1])
    (gen, score), shapes = res[0]
    np.testing.assert_array_equal(gen[0], want)
    np.testing.assert_allclose(score[0], nll, rtol=1e-5, atol=1e-6)
    hidden = solo.blocks[0].w1.shape[1]
    assert shapes["wq"][0] == 1 and shapes["w1"] == (16, hidden // 2)
    assert shapes["w2"] == (hidden // 2, 16)
    assert shapes["head"] == (16, VOCAB // 2)
    assert shapes["heads"] == (1, 1) and shapes["cache_k"][1] == 1
    np.testing.assert_array_equal(q_res[1][0][0][0], q_want)


def test_mesh_serving_rope_swiglu(tmp_path):
    """A rotary SwiGLU model (no position table, no FFN biases) on a
    (1, 2) mesh serves solo's tokens."""
    from test_torch_parallel import _jax_state, _w_serve
    from test_torch_spawn import run_world

    kw = dict(vocab=VOCAB, dim=16, heads=2, hidden=16, rope=True,
              ffn="swiglu")
    ref = compile(jax_models.flash_transformer(**kw), backend="jax", seed=0)
    prompt = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    want = np.asarray(JaxServer(ref).generate(prompt, n_new=8))
    res = run_world(tmp_path, _w_serve, 2, (1, 2), "flash_transformer", kw,
                    _jax_state(ref), {},
                    [("generate", (prompt,), {"n_new": 8})])
    np.testing.assert_array_equal(res[0][0][0][0], want)


def test_mesh_serving_drops_names_it_cannot_split(tmp_path):
    """One kv head under model=2 (each rank computes the kv head its
    query head attends) and an odd vocab (the head stays whole): the
    placement drops those names and the tokens equal solo's, with a
    sampled run the same on both ranks."""
    from test_torch_parallel import _jax_state, _w_serve
    from test_torch_spawn import run_world

    kw = dict(vocab=9, dim=16, heads=2, kv_heads=1, eta=0.01)
    ref = compile(jax_models.flash_transformer(**kw), backend="jax", seed=0)
    prompt = np.random.default_rng(3).integers(0, 9, (2, 5)).astype(
        np.float32)
    port = egt.from_state(flash_transformer(**kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")
    want = FlashLMServer(port).generate(prompt, n_new=6).numpy()
    calls = [("generate", (prompt,), {"n_new": 6}),
             ("generate", (prompt,), {"n_new": 6, "temperature": 1.0,
                                      "seed": 4})]
    res = run_world(tmp_path, _w_serve, 2, (1, 2), "flash_transformer", kw,
                    _jax_state(ref), {}, calls)
    (greedy, sampled), shapes = res[0]
    np.testing.assert_array_equal(greedy[0], want)
    np.testing.assert_array_equal(sampled[0], res[1][0][1][0])
    assert shapes["wk"] == (1, 16, 8) and shapes["wq"][0] == 1
    assert shapes["head"] == (16, 9)
