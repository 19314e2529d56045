"""Port parity: the encoder-decoder server
(exprgrad_torch/models/seq2seq_serve.py).

The same weights (a tiny_seq2seq trained briefly on sequence reversal by
the JAX package, carried over with ``egt.from_state``) serve through the
JAX package's Seq2SeqServer and the port's, float32 caches on both, on
the same numpy sources:

* prefill logits against the port's "predict" and the JAX server's
  prefill (``rtol=1e-5``);
* greedy ``generate`` equal to the port's ``greedy_decode`` and to the
  JAX server's tokens; ragged ``lengths`` equal to each source alone;
* one beam equal to greedy, beam tokens and scores equal to the JAX
  server's, each score within 1e-5 of the teacher-forced log-probability;
* greedy speculation (the target as its own draft, and a narrower
  draft) equal to greedy, with the JAX server's number of rounds;
* ``score`` against predict's NLL and the JAX server's (``rtol=1e-5``);
* int8 weights: the JAX package's codes, logits within 5% relative L2 of
  full precision, with an int8 cache too;
* sampled modes: the same seed gives the same tokens, and the first
  draw's frequencies over many rows follow the softmax (``jax.random``
  streams cannot be reproduced, so single draws are not compared);
* the JAX tests' refusals raise the same error types.

A float64 model does not apply: the decoder's cache and
``decode_attention`` are float32 in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import exprgrad_torch as egt
import exprgrad_tpu as eg
import exprgrad_tpu.models as jm
from exprgrad_torch.errors import ModelRuntimeError
from exprgrad_torch.models import (Seq2SeqServer, flash_transformer,
                                   greedy_decode, tiny_seq2seq)
from exprgrad_torch.quant import QuantW
from exprgrad_tpu.models import Seq2SeqServer as JaxServer

VOCAB = 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _carry(ref, **kw):
    return egt.from_state(tiny_seq2seq(**kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")


def _reversal(n=32, width=6, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, VOCAB, (n, width)).astype(np.float32)
    rev = src[:, ::-1]
    tgt = np.concatenate([np.zeros((n, 1), np.float32), rev[:, :-1]], 1)
    labels = np.eye(VOCAB, dtype=np.float32)[rev.astype(int)]
    return {"src": src, "tgt": tgt, "labels": labels}


@pytest.fixture(scope="module")
def trained():
    """(JAX model, port model): sequence reversal, 80 adam steps."""
    ref = eg.compile(jm.tiny_seq2seq(eta=0.02), backend="jax", seed=1)
    args = _reversal()
    for _ in range(80):
        ref.epoch += 1
        ref.apply("train", args)
    return ref, _carry(ref, eta=0.02)


@pytest.fixture(scope="module")
def servers(trained):
    ref, port = trained
    return JaxServer(ref), Seq2SeqServer(port)


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _src(seed, shape=(3, 6)):
    return np.random.default_rng(seed).integers(1, VOCAB, shape).astype(
        np.float32)


def test_prefill_matches_predict_and_jax(trained, servers):
    _, port = trained
    jsrv, tsrv = servers
    src = _src(1, (3, 8))
    tgt = _src(2, (3, 5))
    logits, caches = tsrv.prefill(tgt, tsrv.encode(src),
                                  tsrv.init_caches(3, capacity=8))
    assert caches[0].length == 5
    probs = port.call("predict", {"src": src, "tgt": tgt})
    np.testing.assert_allclose(_np(torch.softmax(logits, -1)), probs, **TOL)
    jl, _ = jsrv.prefill(tgt, jsrv.encode(src), jsrv.init_caches(3, 8))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def test_greedy_matches_greedy_decode_and_jax(trained, servers):
    _, port = trained
    jsrv, tsrv = servers
    src = _src(3, (4, 6))
    got = tsrv.generate(src, n_new=6)
    assert got.dtype == torch.int32 and got.device == port.device
    np.testing.assert_array_equal(_np(got), greedy_decode(port, src, 6))
    np.testing.assert_array_equal(_np(got), np.asarray(jsrv.generate(src,
                                                                     6)))


def test_untrained_model_and_bos(trained):
    """An untrained model (flat logits) also gives greedy_decode's
    tokens; another BOS decodes differently."""
    ref = eg.compile(jm.tiny_seq2seq(), backend="jax", seed=0)
    port = _carry(ref)
    srv = Seq2SeqServer(port)
    src = _src(8, (2, 8))
    a = _np(srv.generate(src, n_new=5, bos=0))
    np.testing.assert_array_equal(a, greedy_decode(port, src, 5))
    np.testing.assert_array_equal(a, np.asarray(JaxServer(ref).generate(
        src, 5, bos=0)))
    b = _np(srv.generate(src, n_new=5, bos=3))
    np.testing.assert_array_equal(b, np.asarray(JaxServer(ref).generate(
        src, 5, bos=3)))
    assert not np.array_equal(a, b)


def test_incremental_steps_equal_prefill(servers):
    """Decoding one token at a time gives the whole-prefix prefill's
    logits (the self-attention cache is exact)."""
    _, tsrv = servers
    src = _src(4, (2, 6))
    tgt = _src(5, (2, 5))
    enc = tsrv.encode(src)
    full, _ = tsrv.prefill(tgt, enc, tsrv.init_caches(2, 8))
    caches = tsrv.init_caches(2, 8)
    steps = []
    for i in range(5):
        logits, caches = tsrv._step(tgt[:, i:i + 1], enc, caches)
        steps.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-5,
                               atol=1e-5)


def test_prefill_consumes_its_caches(servers):
    """Caches are functional, as the JAX package's: a prefill writes the
    given storage in place (nothing newer holds it), and two branches
    prefilled from one cache equal the JAX server's, the first branch's
    caches keeping their values."""
    jsrv, tsrv = servers
    caches = tsrv.init_caches(1, 8)
    k0 = caches[0].k
    enc = tsrv.encode(_src(7, (1, 6)))
    _, out = tsrv.prefill(_src(6, (1, 3)), enc, caches)
    assert out[0].k is k0 and bool((k0[:, :, :3] != 0).any())
    assert caches[0].length == 0 and out[0].length == 3
    a, b = _src(8, (1, 2)), _src(9, (1, 2))
    got_a, ca = tsrv.prefill(a, enc, out)
    kept = [c.k.clone() for c in ca]
    got_b, cb = tsrv.prefill(b, enc, out)
    assert cb[0].k.data_ptr() != ca[0].k.data_ptr()
    for c, k in zip(ca, kept):
        assert c.length == 5 and torch.equal(c.k, k)
    jenc = jsrv.encode(_src(7, (1, 6)))
    _, jc = jsrv.prefill(_src(6, (1, 3)), jenc, jsrv.init_caches(1, 8))
    ja, _ = jsrv.prefill(a, jenc, jc)
    jb, _ = jsrv.prefill(b, jenc, jc)
    np.testing.assert_allclose(_np(got_a), np.asarray(ja), **TOL)
    np.testing.assert_allclose(_np(got_b), np.asarray(jb), **TOL)


def test_ragged_sources_match_solo_and_jax(servers):
    jsrv, tsrv = servers
    rng = np.random.default_rng(9)
    lens = [6, 4, 2]
    src = np.zeros((3, 6), np.float32)
    rows = []
    for i, n in enumerate(lens):
        rows.append(rng.integers(1, VOCAB, n).astype(np.float32))
        src[i, :n] = rows[-1]
    got = _np(tsrv.generate(src, n_new=6, lengths=lens))
    np.testing.assert_array_equal(got, np.asarray(jsrv.generate(
        src, 6, lengths=lens)))
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(
            got[i], _np(tsrv.generate(row[None], n_new=6))[0])


def test_stop_token_freezes_like_jax(servers):
    jsrv, tsrv = servers
    src = _src(7, (4, 6))
    plain = _np(tsrv.generate(src, n_new=6))
    stop = int(plain[0, 2])
    out = _np(tsrv.generate(src, n_new=6, stop_token=stop))
    np.testing.assert_array_equal(out, np.asarray(jsrv.generate(
        src, 6, stop_token=stop)))
    for row in out:
        hits = np.where(row == stop)[0]
        if len(hits):
            assert (row[hits[0]:] == stop).all()


def test_beam_matches_greedy_jax_and_teacher_forcing(servers):
    jsrv, tsrv = servers
    src = _src(10, (3, 6))
    toks, scores = tsrv.generate_beam(src, n_new=6, beams=1)
    np.testing.assert_array_equal(_np(toks)[:, 0],
                                  _np(tsrv.generate(src, n_new=6)))
    toks, scores = tsrv.generate_beam(src, n_new=4, beams=3)
    jt, js = jsrv.generate_beam(src, 4, beams=3)
    np.testing.assert_array_equal(_np(toks), np.asarray(jt))
    np.testing.assert_allclose(_np(scores), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    assert (np.diff(_np(scores), axis=1) <= 1e-6).all()
    for b in range(3):
        for beam in range(3):
            nll, _ = tsrv.score(src[b:b + 1], _np(toks)[b, beam][None])
            np.testing.assert_allclose(float(scores[b, beam]),
                                       -float(nll[0]), rtol=0, atol=1e-5)


def test_beam_on_ragged_sources_matches_solo(servers):
    _, tsrv = servers
    rng = np.random.default_rng(12)
    lens = [6, 3]
    src = np.zeros((2, 6), np.float32)
    rows = []
    for i, n in enumerate(lens):
        rows.append(rng.integers(1, VOCAB, n).astype(np.float32))
        src[i, :n] = rows[-1]
    toks, scores = tsrv.generate_beam(src, n_new=5, beams=2, lengths=lens)
    for i, row in enumerate(rows):
        st, ss = tsrv.generate_beam(row[None], n_new=5, beams=2)
        np.testing.assert_array_equal(_np(toks)[i], _np(st)[0])
        np.testing.assert_allclose(_np(scores)[i], _np(ss)[0], atol=1e-5)


def test_speculative_matches_greedy_and_jax_rounds(trained, servers):
    jsrv, tsrv = servers
    src = _src(0, (1, 6))
    want = _np(tsrv.generate(src, n_new=6))
    narrow_ref = eg.compile(jm.tiny_seq2seq(dim=8, heads=2, hidden=16),
                            backend="jax", seed=9)
    narrow = Seq2SeqServer(_carry(narrow_ref, dim=8, heads=2, hidden=16))
    jnarrow = JaxServer(narrow_ref)
    for k in (1, 3):
        got, steps = tsrv.generate_speculative(narrow, src, n_new=6, k=k)
        np.testing.assert_array_equal(_np(got), want)
        jgot, jsteps = jsrv.generate_speculative(jnarrow, src, 6, k=k)
        np.testing.assert_array_equal(np.asarray(jgot), want)
        assert steps == int(jsteps)
    got, steps = tsrv.generate_speculative(tsrv, src, n_new=6, k=3)
    np.testing.assert_array_equal(_np(got), want)
    assert steps <= 3  # the target as its own draft accepts everything


def test_sampled_speculation_is_seeded(servers):
    _, tsrv = servers
    src = _src(1, (1, 6))
    a, _ = tsrv.generate_speculative(tsrv, src, n_new=6, k=2,
                                     temperature=0.9, seed=3)
    b, _ = tsrv.generate_speculative(tsrv, src, n_new=6, k=2,
                                     temperature=0.9, seed=3)
    assert torch.equal(a, b) and a.shape == (1, 6)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB


def test_score_matches_predict_nll_and_jax(trained, servers):
    _, port = trained
    jsrv, tsrv = servers
    src = _src(6, (3, 6))
    ids = np.random.default_rng(6).integers(0, VOCAB, (3, 6))
    nll, mean = tsrv.score(src, ids)
    prefix = np.concatenate([np.zeros((3, 1)), ids[:, :-1]], 1).astype(
        np.float32)
    probs = port.call("predict", {"src": src, "tgt": prefix})
    want = -np.log(np.take_along_axis(probs, ids[:, :, None], -1)[..., 0]
                   ).sum(-1)
    np.testing.assert_allclose(_np(nll), want, rtol=1e-5)
    np.testing.assert_allclose(_np(mean) * 6, _np(nll), rtol=1e-6)
    jn, jm_ = jsrv.score(src, ids)
    np.testing.assert_allclose(_np(nll), np.asarray(jn), rtol=1e-5)
    np.testing.assert_allclose(_np(mean), np.asarray(jm_), rtol=1e-5)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_int8_weights_track_full_precision(trained, servers, cache):
    ref, port = trained
    _, full = servers
    ct = getattr(torch, cache)
    quant = Seq2SeqServer(port, weight_dtype=torch.int8, cache_dtype=ct)
    n_q = sum(isinstance(v, QuantW) for blk in quant.enc + quant.dec
              for v in blk.values())
    assert n_q == 6 * len(quant.enc) + 10 * len(quant.dec)
    assert quant.p["head.weights"].codes.dtype == torch.int8
    jq = JaxServer(ref, weight_dtype=jnp.int8, cache_dtype=getattr(jnp,
                                                                    cache))
    np.testing.assert_array_equal(_np(quant.dec[0]["cross.wo"].codes),
                                  np.asarray(jq.dec[0]["cross.wo"].codes))
    src = _src(5, (4, 6))
    tgt = _src(4, (4, 6))
    got, _ = quant.prefill(tgt, quant.encode(src), quant.init_caches(4, 8))
    want, _ = full.prefill(tgt, full.encode(src), full.init_caches(4, 8))
    assert _rel_l2(_np(got), _np(want)) < 0.05
    np.testing.assert_array_equal(_np(quant.generate(src, n_new=6)),
                                  np.asarray(jq.generate(src, 6)))


def test_sampling_is_seeded_and_follows_the_softmax(servers):
    _, tsrv = servers
    src = _src(5, (2, 6))
    a = tsrv.generate(src, n_new=5, temperature=1.0, seed=1)
    b = tsrv.generate(src, n_new=5, temperature=1.0, seed=1)
    assert torch.equal(a, b)
    k1 = tsrv.generate(src, n_new=5, temperature=0.7, top_k=1, seed=3)
    assert torch.equal(k1, tsrv.generate(src, n_new=5))
    p = tsrv.generate(src, n_new=5, temperature=1.0, top_p=0.9, seed=4)
    assert torch.equal(p, tsrv.generate(src, n_new=5, temperature=1.0,
                                        top_p=0.9, seed=4))
    # the first draw over 4000 copies of one source against its softmax
    rows = np.repeat(src[:1], 4000, axis=0)
    first = _np(tsrv.generate(rows, n_new=1, temperature=1.0, seed=7))[:, 0]
    logits, _ = tsrv.prefill(np.zeros((1, 1), np.float32),
                             tsrv.encode(src[:1]), tsrv.init_caches(1, 2))
    want = _np(torch.softmax(logits[0, 0], -1))
    freq = np.bincount(first, minlength=VOCAB) / first.size
    assert np.abs(freq - want).max() < 0.03, (freq, want)


def test_multiblock_serves_like_greedy_decode():
    ref = eg.compile(jm.tiny_seq2seq(enc_blocks=2, dec_blocks=2),
                     backend="jax", seed=0)
    port = _carry(ref, enc_blocks=2, dec_blocks=2)
    srv = Seq2SeqServer(port)
    assert len(srv.enc) == 2 and len(srv.dec) == 2
    src = _src(13, (2, 6))
    got = _np(srv.generate(src, n_new=5))
    np.testing.assert_array_equal(got, greedy_decode(port, src, 5))
    np.testing.assert_array_equal(got, np.asarray(JaxServer(ref).generate(
        src, 5)))
    toks, _ = srv.generate_beam(src, n_new=4, beams=2)
    np.testing.assert_array_equal(_np(toks)[:, 0], got[:, :4])


def test_refusals_match_jax(trained, servers):
    ref, port = trained
    jsrv, tsrv = servers
    fl = dict(vocab=8, dim=16, heads=2, hidden=32, max_seq=16)
    jflash = eg.compile(jm.flash_transformer(**fl), backend="jax", seed=0)
    tflash = egt.compile(flash_transformer(**fl), seed=0, device="cpu")
    src = np.zeros((2, 6), np.float32)
    cases = [
        (lambda s, m: s(m), "Seq2SeqServer serves", (jflash, tflash)),
        (lambda s, m: m.generate(np.zeros((1, 8), np.float32), 64),
         "max_tgt", (jsrv, tsrv)),
        (lambda s, m: m.generate(np.zeros((1, 64), np.float32), 4),
         "max_src", (jsrv, tsrv)),
        (lambda s, m: m.generate(src, 3, temperature=1.0, top_p=1.5),
         "top_p", (jsrv, tsrv)),
        (lambda s, m: m.generate_beam(src, 4, beams=2, lengths=[10, 3]),
         "lengths", (jsrv, tsrv)),
        (lambda s, m: m.generate(src, 4, lengths=[1]), "lengths",
         (jsrv, tsrv)),
        (lambda s, m: m.generate_beam(src, 0, beams=2), "n_new",
         (jsrv, tsrv)),
        (lambda s, m: m.generate_beam(src, 4, beams=VOCAB + 1), "beams",
         (jsrv, tsrv)),
        (lambda s, m: m.generate_speculative(m, src, 4), "one sequence",
         (jsrv, tsrv)),
        (lambda s, m: m.generate_speculative(m, src[:1], 4, k=0), "k must",
         (jsrv, tsrv)),
        (lambda s, m: m.generate_speculative(m, src[:1], 30, k=4),
         "max_tgt", (jsrv, tsrv)),
    ]
    for call, match, (jarg, targ) in cases:
        with pytest.raises(eg.ModelRuntimeError, match=match):
            call(JaxServer, jarg)
        with pytest.raises(ModelRuntimeError, match=match):
            call(Seq2SeqServer, targ)
    with pytest.raises(eg.ModelRuntimeError):
        JaxServer(ref, weight_dtype=jnp.float16)
    with pytest.raises(ModelRuntimeError):
        Seq2SeqServer(port, weight_dtype=torch.float16)
    # a model quantized by Model.quantize_weights is refused
    qref = eg.compile(jm.tiny_seq2seq(), backend="jax", seed=0)
    qref.quantize_weights(min_size=1)
    qport = _carry(eg.compile(jm.tiny_seq2seq(), backend="jax", seed=0))
    qport.quantize_weights(min_size=1)
    with pytest.raises(eg.ModelRuntimeError, match="already quantized"):
        JaxServer(qref)
    with pytest.raises(ModelRuntimeError, match="already quantized"):
        Seq2SeqServer(qport)
    with pytest.raises(ModelRuntimeError, match="make_mesh"):
        Seq2SeqServer(port, mesh=object())


def test_mesh_tensor_parallel_seq2seq_serving(tmp_path, trained):
    """Encoder-decoder serving on a 2 x 2 mesh of gloo ranks with int8
    weights: greedy, beam and score equal the one-device int8 server of
    the JAX package (tests/test_seq2seq_serve.py's mesh case)."""
    from test_torch_parallel import _jax_state, _w_serve
    from test_torch_spawn import run_world

    ref, _ = trained
    jq = JaxServer(ref, weight_dtype=jnp.int8)
    src = _src(9, (4, 6))
    want = np.asarray(jq.generate(src, n_new=6))
    b_want, s_want = jq.generate_beam(src[:2], n_new=5, beams=3)
    nll_want = np.asarray(jq.score(src, src[:, ::-1])[0])
    calls = [("generate", (src,), {"n_new": 6}),
             ("generate_beam", (src[:2],), {"n_new": 5, "beams": 3}),
             ("score", (src, src[:, ::-1].copy()), {})]
    res = run_world(tmp_path, _w_serve, 4, (2, 2), "tiny_seq2seq",
                    {"eta": 0.02}, _jax_state(ref), {"weight_dtype": "int8"},
                    calls)
    (gen, beam, score), shapes = res[0]
    np.testing.assert_array_equal(gen[0], want)
    np.testing.assert_array_equal(beam[0], np.asarray(b_want))
    np.testing.assert_allclose(beam[1], np.asarray(s_want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(score[0], nll_want, rtol=1e-4, atol=1e-5)
    assert shapes["heads"][0] * 2 == Seq2SeqServer(trained[1]).heads
