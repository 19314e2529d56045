"""Port parity: the decoder server's remaining modes
(exprgrad_torch/models/serve.py, _beam.py, _spec.py).

The same trained weights (``tests/test_torch_serve.py``'s briefly trained
+1-cycle model, so no two top logits nearly tie) serve through the JAX
package's FlashLMServer and the port's, float32 caches on both:

* ragged greedy ``generate(lengths=)`` gives the same tokens, and each
  row the tokens of its prompt served alone (MHA, MQA, rope with a
  window); ``stop_seq`` freezes rows alike; prompt buckets give the
  unbucketed tokens;
* ``score`` within ``rtol=1e-5``;
* ``generate_beam`` the same tokens and scores within ``rtol=1e-5``,
  with and without ``stop_token``;
* greedy ``generate_speculative`` the same tokens and the same number of
  verify rounds, with a draft that disagrees (rejected K/V are rewound)
  and with the target as its own draft; ``generate_lookup`` likewise;
* sampled speculation holds the target's distribution: the joint of the
  first two tokens over 250 seeds within 0.09 of ``p(t1) p(t2 | t1)``,
  the JAX test's bound (``jax.random`` streams cannot be reproduced, so
  single draws are not compared);
* the validation errors of tests/test_serve.py raise alike.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import exprgrad_torch as egt
import exprgrad_tpu as eg
import exprgrad_tpu.models as jax_models
from exprgrad_torch.models import FlashLMServer, flash_transformer
from exprgrad_torch.models._spec import lookup_propose
from exprgrad_tpu.models.serve import FlashLMServer as JaxServer

from tests.test_torch_serve import VOCAB, _trained

SCORE_TOL = dict(rtol=1e-5, atol=0)

MODELS = {"mha": (), "mqa": (("kv_heads", 1),),
          "rope_window": (("rope", True), ("window", 4))}


@functools.lru_cache(maxsize=None)
def _servers(kw=()):
    """(JAX server, port server) over the same trained weights, float32
    caches."""
    ref, port = _trained(**dict(kw))
    return (JaxServer(ref, cache_dtype=jnp.float32),
            FlashLMServer(port, cache_dtype=torch.float32))


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _padded(prompts):
    lengths = [len(p) for p in prompts]
    out = np.zeros((len(prompts), max(lengths)), np.float32)
    for i, p in enumerate(prompts):
        out[i, :len(p)] = p
    return out, lengths


@pytest.mark.parametrize("model", list(MODELS))
def test_ragged_greedy_matches_jax_and_solo(model):
    jsrv, tsrv = _servers(MODELS[model])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, n).astype(np.float32)
               for n in (3, 7, 2, 5)]
    padded, lengths = _padded(prompts)
    got = _np(tsrv.generate(padded, n_new=6, lengths=lengths, capacity=13))
    want = _np(jsrv.generate(padded, n_new=6, lengths=lengths, capacity=13))
    np.testing.assert_array_equal(got, want)
    for i, p in enumerate(prompts):
        solo = _np(tsrv.generate(p[None], n_new=6))[0]
        np.testing.assert_array_equal(got[i], solo, err_msg=f"row {i}")


def test_stop_seq_and_prompt_buckets_match_jax():
    jsrv, tsrv = _servers()
    prompt = np.asarray([[2.0, 3.0, 4.0], [0.0, 1.0, 2.0]], np.float32)
    free = _np(tsrv.generate(prompt, n_new=8))
    seq = [int(free[0, 1]), int(free[0, 2])]
    got = _np(tsrv.generate(prompt, n_new=8, stop_seq=seq))
    np.testing.assert_array_equal(
        got, _np(jsrv.generate(prompt, n_new=8, stop_seq=seq)))
    np.testing.assert_array_equal(got[0, :3], free[0, :3])
    assert (got[0, 2:] == seq[-1]).all()
    # a one-token sequence is stop_token
    np.testing.assert_array_equal(
        _np(tsrv.generate(prompt, n_new=8, stop_seq=[seq[0]])),
        _np(tsrv.generate(prompt, n_new=8, stop_token=seq[0])))
    # ragged rows with a stop sequence
    ragged = np.asarray([[2.0, 3.0, 4.0], [0.0, 1.0, 0.0]], np.float32)
    got = _np(tsrv.generate(ragged, n_new=6, lengths=[3, 2], stop_seq=seq))
    np.testing.assert_array_equal(got, _np(jsrv.generate(
        ragged, n_new=6, lengths=[3, 2], stop_seq=seq)))
    assert (got[0, 2:] == seq[-1]).all()

    # buckets: three widths pad to one bucket; the tokens are the
    # unbucketed call's (and the JAX package's bucketed call's)
    _, port = _trained()
    bucketed = FlashLMServer(port, cache_dtype=torch.float32)
    bucketed.set_prompt_buckets([16])
    rng = np.random.default_rng(17)
    for w in (5, 9, 13):
        p = rng.integers(0, VOCAB, (2, w)).astype(np.float32)
        out = _np(bucketed.generate(p, n_new=4))
        np.testing.assert_array_equal(out, _np(tsrv.generate(p, n_new=4)))
        assert bucketed._prompt_bucket(w) == 16
    jsrv.set_prompt_buckets([16])
    try:
        np.testing.assert_array_equal(
            out, _np(jsrv.generate(p, n_new=4)))
    finally:
        jsrv.prompt_buckets = None
    # the bucket is clamped so width + n_new - 1 fits the capacity
    wide = FlashLMServer(port, cache_dtype=torch.float32)
    wide.set_prompt_buckets([1024])
    p = np.zeros((1, 5), np.float32)
    np.testing.assert_array_equal(_np(wide.generate(p, n_new=4)),
                                  _np(tsrv.generate(p, n_new=4)))


def test_score_matches_jax_and_predict():
    jsrv, tsrv = _servers()
    ref, port = _trained()
    toks = np.random.default_rng(5).integers(0, VOCAB, (3, 8)).astype(
        np.float32)
    got = _np(tsrv.score(toks))
    np.testing.assert_allclose(got, _np(jsrv.score(toks)), **SCORE_TOL)
    probs = port.call("predict", {"tokens": toks})
    ids = toks.astype(int)
    want = -np.mean(np.log(np.take_along_axis(
        probs[:, :-1], ids[:, 1:, None], axis=-1)[..., 0]), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    lengths = [8, 5, 3]
    ragged = _np(tsrv.score(toks, lengths=lengths))
    np.testing.assert_allclose(
        ragged, _np(jsrv.score(toks, lengths=lengths)), **SCORE_TOL)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(ragged[b], _np(tsrv.score(toks[b:b + 1,
                                                                 :n]))[0],
                                   rtol=1e-4, atol=1e-5)


def _path_logprob(server, prompt, seq):
    """Teacher-forced log-probability of ``seq`` after ``prompt``."""
    toks = np.concatenate([prompt, np.asarray(seq, np.float32)])[None]
    logits, _ = server.prefill(toks, server.init_caches(1))
    logp = torch.log_softmax(logits[0].float(), -1)
    t = len(prompt)
    return float(sum(logp[t - 1 + i, int(s)] for i, s in enumerate(seq)))


@pytest.mark.parametrize("stop", [False, True], ids=["free", "stop_token"])
def test_beam_matches_jax(stop):
    jsrv, tsrv = _servers()
    prompts = np.asarray([[2.0, 3.0, 4.0], [0.0, 1.0, 2.0]], np.float32)
    kw = dict(n_new=6, beams=3)
    if stop:
        kw["stop_token"] = int(_np(tsrv.generate(prompts[:1], n_new=6))[0, 1])
    seqs, scores = tsrv.generate_beam(prompts, **kw)
    jseqs, jscores = jsrv.generate_beam(prompts, **kw)
    assert seqs.dtype == torch.int32 and tuple(seqs.shape) == (2, 3, 6)
    np.testing.assert_array_equal(_np(seqs), _np(jseqs))
    np.testing.assert_allclose(_np(scores), _np(jscores), **SCORE_TOL)
    assert (np.diff(_np(scores), axis=1) <= 1e-6).all()
    greedy = _np(tsrv.generate(prompts, n_new=6))
    if not stop:
        np.testing.assert_array_equal(_np(seqs)[:, 0], greedy)
    for b in range(2):
        s = _np(seqs)[b, 0]
        if stop and kw["stop_token"] in s:
            s = s[:list(s).index(kw["stop_token"]) + 1]
        np.testing.assert_allclose(_np(scores)[b, 0],
                                   _path_logprob(tsrv, prompts[b], s),
                                   rtol=1e-4, atol=1e-4)


def test_beam_finds_exhaustive_best_on_a_flat_model():
    """On a lightly trained model beam 0 is the best of all vocab^2
    two-token continuations (a pruning fault would keep the scores
    self-consistent but drop the best path)."""
    import itertools

    _, port = _trained(steps=8)
    srv = FlashLMServer(port, cache_dtype=torch.float32)
    prompt = np.asarray([2.0, 3.0], np.float32)
    seqs, scores = srv.generate_beam(prompt[None], n_new=2, beams=4)
    best = max(itertools.product(range(VOCAB), repeat=2),
               key=lambda s: _path_logprob(srv, prompt, s))
    assert list(_np(seqs)[0, 0]) == list(best)
    np.testing.assert_allclose(_np(scores)[0, 0],
                               _path_logprob(srv, prompt, best),
                               rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _drafts():
    """An untrained draft (its proposals mostly miss, so rounds reject
    and rewind) in both packages, same weights."""
    graph = dict(vocab=VOCAB, dim=16, heads=2)
    ref = eg.compile(jax_models.flash_transformer(**graph), seed=9)
    port = egt.compile(flash_transformer(**graph), seed=9, device="cpu")
    return (JaxServer(ref, cache_dtype=jnp.float32),
            FlashLMServer(port, cache_dtype=torch.float32))


def test_speculative_greedy_matches_jax_with_rewinds():
    """Greedy speculation equals plain greedy for any draft, in the JAX
    package's number of verify rounds.  The untrained draft disagrees, so
    rounds reject proposals: a later step that attended rejected K/V
    would change the tokens."""
    jsrv, tsrv = _servers()
    jdraft, tdraft = _drafts()
    prompt = np.asarray([[1, 2, 3, 4, 0]], np.float32)
    want = _np(tsrv.generate(prompt, n_new=16))
    for k in (1, 3, 5):
        got, steps = tsrv.generate_speculative(tdraft, prompt, n_new=16, k=k)
        jgot, jsteps = jsrv.generate_speculative(jdraft, prompt, n_new=16,
                                                 k=k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(_np(got), _np(jgot))
        assert steps == int(jsteps), (k, steps, int(jsteps))
        if k > 1:  # some round rejected: more rounds than all-accepted
            assert steps > math.ceil(15 / k), (k, steps)
    # the target as its own draft accepts everything: ceil(11 / 4) rounds
    got, steps = tsrv.generate_speculative(tsrv, prompt, n_new=12, k=4)
    np.testing.assert_array_equal(_np(got), _np(tsrv.generate(prompt,
                                                              n_new=12)))
    assert steps == 3


def test_speculative_windowed_self_draft():
    _, tsrv = _servers(MODELS["rope_window"])
    prompt = np.asarray([[1, 5, 2, 3]], np.float32)
    got, _ = tsrv.generate_speculative(tsrv, prompt, n_new=14, k=3)
    np.testing.assert_array_equal(_np(got), _np(tsrv.generate(prompt,
                                                              n_new=14)))


def test_speculative_sampling_preserves_target_distribution():
    """The rejection scheme: over 250 seeds the first two tokens' joint
    matches the target's p(t1) p(t2 | t1) (untrained models: spread
    distributions and a disagreeing draft, so the correction draw fires
    often).  A fixed seed gives the same tokens twice."""
    vocab = 6
    model = egt.compile(flash_transformer(vocab=vocab, dim=16, heads=2,
                                          max_seq=32), seed=0, device="cpu")
    target = FlashLMServer(model)
    draft = FlashLMServer(egt.compile(
        flash_transformer(vocab=vocab, dim=8, heads=2, max_seq=32), seed=3,
        device="cpu"))
    prompt = np.asarray([[1, 2, 3, 4]], np.float32)
    p1 = model.call("predict", {"tokens": prompt})[0, -1].astype(np.float64)
    p1 /= p1.sum()
    joint = np.zeros((vocab, vocab))
    for t1 in range(vocab):
        ext = np.concatenate([prompt, [[t1]]], axis=1).astype(np.float32)
        p2 = model.call("predict", {"tokens": ext})[0, -1].astype(np.float64)
        joint[t1] = p1[t1] * p2 / p2.sum()
    n = 250
    emp = np.zeros((vocab, vocab))
    for s in range(n):
        out, _ = target.generate_speculative(draft, prompt, n_new=2, k=2,
                                             temperature=1.0, seed=s)
        emp[tuple(_np(out)[0])] += 1
    emp /= n
    assert np.abs(emp - joint).max() < 0.09, np.abs(emp - joint).max()
    a, _ = target.generate_speculative(draft, prompt, n_new=6, k=3,
                                       temperature=0.9, seed=11)
    b, _ = target.generate_speculative(draft, prompt, n_new=6, k=3,
                                       temperature=0.9, seed=11)
    np.testing.assert_array_equal(_np(a), _np(b))


def test_break_even_warning():
    import warnings

    _, tsrv = _servers()
    prompt = np.asarray([[2, 4, 1]], np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, steps = tsrv.generate_speculative(tsrv, prompt, n_new=12, k=4,
                                             break_even=1.5)
    with pytest.warns(RuntimeWarning, match="break-even"):
        tsrv.generate_speculative(tsrv, prompt, n_new=12, k=4,
                                  break_even=12.0 / steps + 1.0)


def test_lookup_matches_jax():
    """Prompt lookup on a periodic prompt (the +1 cycle, which the model
    continues) accepts many tokens a round; on a random prompt it still
    gives the greedy tokens.  Rounds equal the JAX package's."""
    jsrv, tsrv = _servers()
    periodic = (np.arange(12) % VOCAB)[None].astype(np.float32)
    rnd = np.random.default_rng(4).integers(0, VOCAB, (1, 9)).astype(
        np.float32)
    for prompt, n_new, k, ngram in ((periodic, 20, 8, 2), (periodic, 20, 4, 1),
                                    (rnd, 17, 4, 2)):
        got, steps = tsrv.generate_lookup(prompt, n_new=n_new, k=k,
                                          ngram=ngram)
        jgot, jsteps = jsrv.generate_lookup(prompt, n_new=n_new, k=k,
                                            ngram=ngram)
        np.testing.assert_array_equal(_np(got), _np(tsrv.generate(
            prompt, n_new=n_new)))
        np.testing.assert_array_equal(_np(got), _np(jgot))
        assert steps == int(jsteps)
        if prompt is periodic:
            assert steps < n_new // 2, steps


def test_lookup_propose_matches_the_in_graph_rule():
    hist = np.asarray([1, 2, 3, 1, 2, 5, 1, 2], np.int64)
    np.testing.assert_array_equal(lookup_propose(hist, 3, 2), [5, 1, 2])
    np.testing.assert_array_equal(lookup_propose(hist, 4, 1), [5, 1, 2, 2])
    np.testing.assert_array_equal(lookup_propose(hist[:2], 2, 2), [2, 2])
    np.testing.assert_array_equal(lookup_propose(hist[:3], 2, 1), [3, 3])


def test_validation_errors_match_jax():
    jsrv, tsrv = _servers()
    other = {
        tsrv: FlashLMServer(egt.compile(flash_transformer(
            vocab=4, dim=16, heads=2), seed=0, device="cpu")),
        jsrv: JaxServer(eg.compile(jax_models.flash_transformer(
            vocab=4, dim=16, heads=2), seed=0)),
    }
    p2 = np.zeros((2, 4), np.float32)
    p1 = np.zeros((1, 4), np.float32)
    for srv, err in ((jsrv, eg.ModelRuntimeError),
                     (tsrv, egt.ModelRuntimeError)):
        cases = [
            ("lengths", lambda: srv.generate(p2, n_new=2, lengths=[3])),
            ("lengths", lambda: srv.generate(p2, n_new=2, lengths=[3, 5])),
            ("max_seq", lambda: srv.generate(p2, n_new=62, lengths=[4, 2])),
            ("mutually exclusive", lambda: srv.generate(
                p2, n_new=2, stop_token=1, stop_seq=[1, 2])),
            ("stop_seq", lambda: srv.generate(p2, n_new=2, stop_seq=[])),
            ("stop_seq", lambda: srv.generate(p2, n_new=2,
                                              stop_seq=[0, VOCAB])),
            ("2 tokens", lambda: srv.score(np.zeros((1, 1), np.float32))),
            ("lengths", lambda: srv.score(p2, lengths=[1, 4])),
            ("max_seq", lambda: srv.score(np.zeros((1, 65), np.float32))),
            ("beams", lambda: srv.generate_beam(p1, n_new=2, beams=0)),
            ("beams", lambda: srv.generate_beam(p1, n_new=2,
                                                beams=VOCAB + 1)),
            ("max_seq", lambda: srv.generate_beam(p1, n_new=64, beams=2)),
            ("one sequence", lambda: srv.generate_speculative(
                srv, p2, n_new=4)),
            ("vocab", lambda: srv.generate_speculative(other[srv], p1,
                                                       n_new=4)),
            ("k must", lambda: srv.generate_speculative(srv, p1, n_new=4,
                                                        k=0)),
            ("capacity", lambda: srv.generate_speculative(
                srv, p1, n_new=4, capacity=8)),
            ("ngram", lambda: srv.generate_lookup(p1, n_new=4, ngram=0)),
            ("ngram", lambda: srv.generate_lookup(p1, n_new=4, ngram=6)),
            ("one sequence", lambda: srv.generate_lookup(p2, n_new=4)),
            ("max_seq", lambda: srv.generate_lookup(p1, n_new=10_000)),
        ]
        for match, call in cases:
            with pytest.raises(err, match=match):
                call()


def test_one_beam_is_greedy_and_beams_may_end_below_greedy_like_jax():
    """One beam is greedy decoding.  Several beams need not reach the
    greedy sequence's log-probability: greedy's prefix is pruned when
    ``beams`` other prefixes beat it at some step.  On an untrained
    vocab-32 model with 2 beams that happens on some of 128 prompts, in
    the JAX package exactly as in the port (same tokens, same scores)."""
    kw = dict(vocab=32, dim=16, heads=2, max_seq=64)
    port = FlashLMServer(egt.compile(flash_transformer(**kw), seed=0,
                                     device="cpu"), cache_dtype=torch.float32)
    ref = JaxServer(eg.compile(jax_models.flash_transformer(**kw), seed=0),
                    cache_dtype=jnp.float32)
    n, new = 128, 8
    prompts = np.random.default_rng(0).integers(0, 32, (n, 4)).astype(
        np.float32)
    greedy = _np(port.generate(prompts, n_new=new))
    one, _ = port.generate_beam(prompts, n_new=new, beams=1)
    np.testing.assert_array_equal(_np(one)[:, 0], greedy)
    seqs, scores = port.generate_beam(prompts, n_new=new, beams=2)
    jseqs, jscores = ref.generate_beam(prompts, n_new=new, beams=2)
    np.testing.assert_array_equal(_np(seqs), _np(jseqs))
    np.testing.assert_allclose(_np(scores), _np(jscores), **SCORE_TOL)
    full = np.concatenate([prompts, greedy], 1)
    logits, _ = port.prefill(full, port.init_caches(n))
    logp = torch.log_softmax(logits, -1).numpy()
    lp = sum(logp[np.arange(n), 3 + i, greedy[:, i].astype(int)]
             for i in range(new))
    below = _np(scores)[:, 0] < lp - 1e-3
    assert below.any() and (_np(jscores)[:, 0] < lp - 1e-3).sum() == \
        below.sum()
