"""Port parity: continuous batching (exprgrad_torch/models/batcher.py).

The same trained weights serve through the JAX package's
ContinuousBatcher and the port's.  Greedy streams must be equal token
for token between the two and equal to the port's solo
``FlashLMServer.generate`` of each prompt, and the scheduler's ``stats``
(decode steps, dispatches, free pages, preemptions, window evictions,
prefix hits; the port's own prefill and decode token counts aside) must
be equal: dense, paged with a gathered view, paged
through the paged-attention kernel's plain version, a pool small enough
to preempt, int8 caches with a window and rotary positions, window page
eviction, chunked prefill, registered prefixes, stop tokens and stop
sequences, cancellation and token streaming.  Sampled rows cannot be
compared (``jax.random`` is not reproducible in torch): they are checked
for validity.  ``FlashLMServer._step`` on a ragged batch with per-row
positions must match the JAX step within float32 rounding
(``rtol=1e-4, atol=1e-5``, the serving bound of test_torch_serve.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import exprgrad_tpu as eg
import exprgrad_torch as egt
from exprgrad_tpu.models import ContinuousBatcher as JaxBatcher
from exprgrad_tpu.models import FlashLMServer as JaxServer
from exprgrad_tpu.models import flash_transformer as jax_transformer
from exprgrad_torch import ModelRuntimeError
from exprgrad_torch.models import (ContinuousBatcher, FlashLMServer,
                                   flash_transformer)
from exprgrad_torch.models._sample import make_row_picker

VOCAB = 32
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# counters of the port's batcher that the JAX package's does not keep
PORT_ONLY = ("prefill_tokens", "prefill_padded_tokens", "decode_tokens",
             "skinny_launches", "skinny_declined")


def shared(stats: dict) -> dict:
    """The port's ``stats`` without its own counters, to compare with
    the JAX package's."""
    assert set(PORT_ONLY) <= set(stats), stats
    return {k: v for k, v in stats.items() if k not in PORT_ONLY}


@functools.lru_cache(maxsize=None)
def _models(window=None, rope=False):
    """A JAX flash_transformer trained for three steps (as the JAX
    package's batcher tests train it) and its port twin."""
    kw = dict(vocab=VOCAB, dim=16, heads=2, max_seq=64, window=window,
              rope=rope)
    ref = eg.compile(jax_transformer(**kw), backend="jax", seed=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, VOCAB, (4, 16)).astype(np.float32)
    labels = eg.one_hot(rng.integers(0, VOCAB, 64), VOCAB).reshape(
        4, 16, VOCAB)
    for _ in range(3):
        ref.epoch += 1
        ref.apply("train", {"tokens": toks, "labels": labels})
    port = egt.from_state(flash_transformer(**kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")
    return ref, port


_CACHE = {None: (None, None), "int8": (jnp.int8, torch.int8),
          "float32": (jnp.float32, torch.float32)}


@functools.lru_cache(maxsize=None)
def _servers(window=None, rope=False, cache=None):
    ref, port = _models(window, rope)
    jd, td = _CACHE[cache]
    return JaxServer(ref, cache_dtype=jd), FlashLMServer(port, cache_dtype=td)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype(np.float32) for n in sizes]


def _solo(server, prompts, max_new):
    return [server.generate(p[None, :], n_new=mn)[0].numpy().astype(np.int64)
            for p, mn in zip(prompts, max_new)]


@functools.lru_cache(maxsize=None)
def _drafts(seed=5):
    """A draft model (same widths, another seed, three steps on its own
    data, so it often disagrees with the target) in both packages."""
    kw = dict(vocab=VOCAB, dim=16, heads=2, max_seq=64)
    ref = eg.compile(jax_transformer(**kw), backend="jax", seed=seed)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (4, 16)).astype(np.float32)
    labels = eg.one_hot(rng.integers(0, VOCAB, 64), VOCAB).reshape(
        4, 16, VOCAB)
    for _ in range(3):
        ref.epoch += 1
        ref.apply("train", {"tokens": toks, "labels": labels})
    port = egt.from_state(flash_transformer(**kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")
    return JaxServer(ref), FlashLMServer(port)


def _run_both(model, cache, batcher_kw, prompts, max_new, prefix=None):
    """Serve the prompts through both batchers; returns (JAX streams,
    port streams, JAX stats, port stats, port batcher), streams in
    submission order.  ``draft="draft"`` in ``batcher_kw`` stands for
    each package's draft server (:func:`_drafts`), ``draft="self"`` for
    its target server."""
    jsrv, tsrv = _servers(*model, cache)
    out = []
    for i, (cls, srv) in enumerate(((JaxBatcher, jsrv),
                                    (ContinuousBatcher, tsrv))):
        kw = dict(batcher_kw)
        if kw.get("draft") == "draft":
            kw["draft"] = _drafts()[i]
        elif kw.get("draft") == "self":
            kw["draft"] = srv
        b = cls(srv, slots=2, capacity=64, **kw)
        if prefix is not None:
            assert b.register_prefix(prefix) == (
                prefix.size // b.page_size * b.page_size)
        rids = [b.submit(p, mn) for p, mn in zip(prompts, max_new)]
        done = b.run()
        out.append(([np.asarray(done[r]) for r in rids], b.stats, b))
    (jax_streams, jax_stats, _), (streams, stats, port_b) = out
    return jax_streams, streams, jax_stats, stats, port_b


PLAIN, WINDOW_ROPE, WINDOW = (None, False), (8, True), (8, False)

# (id, model, cache dtype, batcher kwargs, prompt sizes, budgets, seed,
#  a stat that must be > 0)
CASES = [
    ("dense", PLAIN, None, dict(), (5, 9, 3, 12, 7), (6, 4, 8, 3, 5), 1,
     None),
    ("dense_int8", PLAIN, "int8", dict(), (6, 10), (5, 5), 4, None),
    ("dense_window_rope", WINDOW_ROPE, None, dict(), (14, 4), (6, 9), 5,
     None),
    ("paged_gather", PLAIN, None, dict(paged=True, page_size=4),
     (5, 9, 3, 13), (6, 4, 8, 5), 9, None),
    ("paged_flash", PLAIN, None,
     dict(paged=True, page_size=8, attention="flash"), (5, 9, 3, 13),
     (6, 4, 8, 5), 21, None),
    ("preemption_gather", PLAIN, None,
     dict(paged=True, page_size=4, pool_pages=5), (9, 8), (8, 8), 10,
     "preemptions"),
    ("preemption_flash", PLAIN, "float32",
     dict(paged=True, page_size=8, pool_pages=3, attention="flash"),
     (9, 8), (8, 8), 10, "preemptions"),
    ("int8_window_rope_gather", WINDOW_ROPE, "int8",
     dict(paged=True, page_size=8), (11, 6), (5, 7), 11, None),
    ("int8_window_rope_flash", WINDOW_ROPE, "int8",
     dict(paged=True, page_size=8, attention="flash"), (11, 6), (5, 7), 22,
     None),
    ("window_eviction", WINDOW, None, dict(paged=True, page_size=4),
     (20, 6), (30, 40), 31, "window_evicted"),
    ("window_tight_pool", WINDOW, None,
     dict(paged=True, page_size=4, pool_pages=9), (6, 9), (40, 35), 32,
     "window_evicted"),
    ("prefill_chunk", PLAIN, None,
     dict(paged=True, page_size=4, prefill_chunk=8), (37, 6, 23),
     (5, 9, 7), 19, None),
    # speculative rounds (draft=) and prompt-lookup rounds (lookup=True):
    # spec_k + 1 query rows a slot per verify dispatch
    ("draft_dense", PLAIN, None, dict(draft="draft", spec_k=3),
     (5, 9, 3, 12), (8, 5, 10, 6), 27, "spec_rounds"),
    ("draft_paged_gather", PLAIN, None,
     dict(draft="draft", spec_k=3, paged=True, page_size=8),
     (5, 9, 3, 12), (8, 5, 10, 6), 27, "spec_rounds"),
    ("draft_paged_flash", PLAIN, "float32",
     dict(draft="draft", spec_k=4, paged=True, page_size=8,
          attention="flash"), (5, 9, 3, 12), (8, 5, 10, 6), 28,
     "spec_rounds"),
    ("draft_int8_window_rope_flash", WINDOW_ROPE, "int8",
     dict(draft="draft", spec_k=2, paged=True, page_size=8,
          attention="flash"), (11, 6), (5, 7), 22, "spec_rounds"),
    ("draft_preemption_flash", PLAIN, "float32",
     dict(draft="draft", spec_k=4, paged=True, page_size=8, pool_pages=4,
          attention="flash"), (9, 8), (8, 8), 10, "preemptions"),
    ("draft_window_eviction", WINDOW, None,
     dict(draft="draft", spec_k=3, paged=True, page_size=4), (20, 6),
     (30, 40), 31, "window_evicted"),
    ("lookup_dense", PLAIN, None, dict(lookup=True, spec_k=3),
     (5, 9, 3, 12), (8, 5, 10, 6), 57, "spec_rounds"),
    ("lookup_paged_gather", PLAIN, None,
     dict(lookup=True, spec_k=3, paged=True, page_size=8),
     (5, 9, 3, 12), (8, 5, 10, 6), 57, "spec_rounds"),
    ("lookup_paged_flash_preemption", PLAIN, "float32",
     dict(lookup=True, spec_k=4, paged=True, page_size=8, pool_pages=4,
          attention="flash"), (9, 8, 6), (8, 8, 10), 59, "preemptions"),
]


@pytest.mark.parametrize(
    "model,cache,kw,sizes,max_new,seed,positive",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_streams_and_stats_match_jax_and_solo(model, cache, kw, sizes,
                                              max_new, seed, positive):
    prompts = _prompts(seed, sizes)
    jax_streams, streams, jax_stats, stats, b = _run_both(
        model, cache, kw, prompts, max_new)
    solo = _solo(_servers(*model, cache)[1], prompts, max_new)
    for got, want, alone in zip(streams, jax_streams, solo):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, alone)
    assert shared(stats) == jax_stats
    if positive is not None:
        assert stats[positive] > 0, stats
    if b.paged:
        assert stats["free_pages"] == stats["pool_pages"]
    assert b.stats["decode_steps"] < sum(max_new)


def test_registered_prefix_matches_jax_and_solo():
    """Prompts that start with a registered prefix reuse its pinned pages
    (prefix hits), with chunked prefill of the rest and a pool that
    preempts; releasing the prefix frees its pages."""
    rng = np.random.default_rng(13)
    system = rng.integers(0, VOCAB, 19).astype(np.float32)
    prompts = [np.concatenate([system, p]) for p in _prompts(14, (6, 21))]
    prompts.append(_prompts(15, (6,))[0])
    max_new = [8, 6, 7]
    for kw in (dict(paged=True, page_size=4, pool_pages=14),
               dict(paged=True, page_size=8, attention="flash",
                    prefill_chunk=8)):
        jax_streams, streams, jax_stats, stats, b = _run_both(
            PLAIN, None, kw, prompts, max_new, prefix=system)
        solo = _solo(_servers()[1], prompts, max_new)
        for got, want, alone in zip(streams, jax_streams, solo):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, alone)
        assert shared(stats) == jax_stats and stats["prefix_hits"] >= 2, \
            stats
        pinned = 16 // b.page_size
        assert stats["free_pages"] == stats["pool_pages"] - pinned
        b.release_prefix(system)
        assert b.stats["free_pages"] == b.stats["pool_pages"]


def _scripted(cls, srv, prompts, stop_seq):
    """Submissions mid-flight, a stop sequence, a cancel of a resident and
    of a queued request, and streamed tokens."""
    b = cls(srv, slots=2, capacity=64, paged=True, page_size=8,
            stream_tokens=True)
    out, drained = {}, []
    r0 = b.submit(prompts[0], 12, stop_seq=stop_seq)
    r1 = b.submit(prompts[1], 30)
    for _ in range(3):
        out.update(b.step())
        drained += b.drain_tokens()
    r2 = b.submit(prompts[2], 7)
    r3 = b.submit(prompts[3], 9)
    out.update(b.step())
    assert b.cancel(r1)            # resident
    assert b.cancel(r3)            # queued
    assert not b.cancel(12345)     # unknown
    out.update(b.run())
    drained += b.drain_tokens()
    assert not b.cancel(r2)        # finished
    return [out.get(r) for r in (r0, r1, r2, r3)], drained, b.stats


def test_stop_seq_cancel_and_streaming_match_jax():
    jsrv, tsrv = _servers()
    prompts = _prompts(9, (5, 7, 4, 6))
    ref0 = _solo(tsrv, prompts[:1], [12])[0]
    stop_seq = [int(ref0[2]), int(ref0[3])]
    want = _scripted(JaxBatcher, jsrv, prompts, stop_seq)
    got = _scripted(ContinuousBatcher, tsrv, prompts, stop_seq)
    streams, drained, stats = got
    assert streams[1] is None and streams[3] is None
    np.testing.assert_array_equal(streams[0], ref0[:4])
    np.testing.assert_array_equal(streams[2],
                                  _solo(tsrv, prompts[2:3], [7])[0])
    for a, b in zip(streams, want[0]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert drained == [(r, int(t)) for r, t in want[1]]
    assert shared(stats) == want[2]
    assert stats["free_pages"] == stats["pool_pages"]


def test_stop_token_matches_jax():
    jsrv, tsrv = _servers()
    prompts = _prompts(3, (5, 7))
    ref = _solo(tsrv, prompts, [12, 12])
    stop = int(ref[0][2])
    got = []
    for cls, srv in ((JaxBatcher, jsrv), (ContinuousBatcher, tsrv)):
        b = cls(srv, slots=2, capacity=64, stop_token=stop)
        rids = [b.submit(p, 12) for p in prompts]
        done = b.run()
        got.append([np.asarray(done[r]) for r in rids])
    for a, b, r in zip(got[1], got[0], ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r[:len(a)])
    assert got[1][0][-1] == stop and len(got[1][0]) <= 3


def test_flash_takes_any_page_size():
    """The CUDA kernel has no sublane rule: attention='flash' accepts a
    page size that is not a multiple of 8 (the JAX package refuses it)
    and serves the same streams as the gather path."""
    _, tsrv = _servers()
    prompts = _prompts(23, (7, 12, 4))
    max_new = [9, 6, 11]
    solo = _solo(tsrv, prompts, max_new)
    for page in (4, 5):
        b = ContinuousBatcher(tsrv, slots=2, capacity=64, paged=True,
                              page_size=page, attention="flash")
        rids = [b.submit(p, mn) for p, mn in zip(prompts, max_new)]
        done = b.run()
        for rid, want in zip(rids, solo):
            np.testing.assert_array_equal(done[rid], want)
    jsrv, _ = _servers()
    with pytest.raises(eg.ModelRuntimeError, match="multiple of 8"):
        JaxBatcher(jsrv, slots=2, capacity=64, paged=True, page_size=4,
                   attention="flash")


def test_sampled_rows_are_valid_and_seeded():
    """Per-request sampling: a greedy row and a top_k=1 row equal solo
    greedy; sampled rows give ids in the vocabulary, the same for the
    same seed."""
    _, tsrv = _servers()
    prompts = _prompts(34, (5, 7, 9, 4))
    refs = _solo(tsrv, prompts[:2], [6, 6])

    def run(seed):
        b = ContinuousBatcher(tsrv, slots=4, capacity=64, paged=True,
                              page_size=8, seed=seed)
        rids = [b.submit(prompts[0], 6),
                b.submit(prompts[1], 6, temperature=0.9, top_k=1),
                b.submit(prompts[2], 6, temperature=1.2, top_p=0.9),
                b.submit(prompts[3], 6, temperature=0.6, top_k=5)]
        done = b.run()
        return [done[r] for r in rids]

    first = run(3)
    np.testing.assert_array_equal(first[0], refs[0])
    np.testing.assert_array_equal(first[1], refs[1])
    for toks in first[2:]:
        assert toks.shape == (6,) and toks.min() >= 0 and toks.max() < VOCAB
    for a, b in zip(first, run(3)):
        np.testing.assert_array_equal(a, b)
    b = ContinuousBatcher(tsrv, slots=2, capacity=64, temperature=0.8,
                          top_k=8, top_p=0.9, seed=7)
    rids = [b.submit(p, 6) for p in prompts[:3]]
    done = b.run()
    for rid in rids:
        assert done[rid].shape == (6,)
        assert done[rid].min() >= 0 and done[rid].max() < VOCAB


def test_row_picker_greedy_rows_are_argmax():
    pick = make_row_picker(6)
    logits = torch.tensor(np.random.default_rng(0).normal(size=(64, 6)),
                          dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    want = torch.argmax(logits, dim=-1)
    n = logits.shape[0]
    greedy = pick(logits, gen, np.zeros(n), np.full(n, 6), np.ones(n))
    assert torch.equal(greedy, want)
    temp = np.where(np.arange(n) % 2, 1.0, 0.0)
    mixed = pick(logits, gen, temp, np.full(n, 6), np.ones(n))
    assert torch.equal(mixed[::2], want[::2])
    k1 = pick(logits, gen, np.ones(n), np.ones(n), np.ones(n))
    assert torch.equal(k1, want)
    top3 = torch.topk(logits, 3, dim=-1).indices
    drawn = pick(logits, gen, np.full(n, 2.0), np.full(n, 3), np.ones(n))
    assert all(int(d) in top3[i].tolist() for i, d in enumerate(drawn))
    # nucleus: the smallest prefix of descending probability reaching 0.5
    probs = torch.softmax(logits, dim=-1)
    sp, order = torch.sort(probs, dim=-1, descending=True)
    keep = torch.cumsum(sp, dim=-1) - sp < 0.5
    drawn = pick(logits, gen, np.ones(n), np.full(n, 6), np.full(n, 0.5))
    for i, d in enumerate(drawn):
        assert int(d) in order[i][keep[i]].tolist()


@pytest.mark.parametrize("model", [PLAIN, WINDOW_ROPE],
                         ids=["plain", "window_rope"])
def test_step_with_positions_matches_jax(model):
    """A right-padded ragged prefill (``_ragged_positions``, ``_embed_at``,
    ``key_pos``/``q_pos``), then one decode token per row at per-row
    cursors (``row_starts``), through both servers' ``_step``."""
    jsrv, tsrv = _servers(*model, "float32")
    rng = np.random.default_rng(40)
    width, cap = 9, 16
    lens = np.asarray([5, 9, 2], np.int32)
    toks = rng.integers(0, VOCAB, (3, width)).astype(np.float32)
    nxt = rng.integers(0, VOCAB, (3, 1)).astype(np.float32)

    jl = jnp.asarray(lens)
    pos_ids, key_pos = jsrv._ragged_positions(jl, width, cap)
    x = jsrv._embed_at(jnp.asarray(toks), pos_ids)
    want, jc = jsrv._step(x, jsrv.init_caches(3, cap), 0, key_pos=key_pos,
                          q_pos=pos_ids)
    kp2 = jnp.where(jnp.arange(cap)[None] <= jl[:, None],
                    jnp.arange(cap)[None], -1)
    want2, _ = jsrv._step(jsrv._embed_at(jnp.asarray(nxt), jl[:, None]), jc,
                          0, key_pos=kp2, q_pos=jl[:, None], row_starts=jl)

    tl = torch.as_tensor(lens)
    pos_ids, key_pos = tsrv._ragged_positions(tl, width, cap)
    x = tsrv._embed_at(torch.as_tensor(toks), pos_ids)
    got, tc = tsrv._step(x, tsrv.init_caches(3, cap), 0, key_pos=key_pos,
                         q_pos=pos_ids)
    kp2 = torch.where(torch.arange(cap)[None] <= tl[:, None],
                      torch.arange(cap)[None], -1)
    got2, _ = tsrv._step(tsrv._embed_at(torch.as_tensor(nxt), tl[:, None]),
                         tc, 0, key_pos=kp2, q_pos=tl[:, None],
                         row_starts=tl)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(),
                                   np.asarray(want)[i, :n], **STEP_TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **STEP_TOL)


def test_validation_matches_jax():
    jsrv, tsrv = _servers()
    for cls, srv, err in ((JaxBatcher, jsrv, eg.ModelRuntimeError),
                          (ContinuousBatcher, tsrv, ModelRuntimeError)):
        with pytest.raises(err, match="paged"):
            cls(srv, slots=2, capacity=64, attention="flash")
        with pytest.raises(err, match="attention"):
            cls(srv, slots=2, capacity=64, paged=True, attention="bogus")
        with pytest.raises(err, match="max_seq"):
            cls(srv, slots=2, capacity=65)
        with pytest.raises(err, match="paged"):
            cls(srv, slots=2, capacity=64, prefill_chunk=8)
        with pytest.raises(err, match="multiple"):
            cls(srv, slots=2, capacity=64, paged=True, page_size=4,
                prefill_chunk=6)
        b = cls(srv, slots=2, capacity=32)
        with pytest.raises(err, match="empty"):
            b.submit([], 4)
        with pytest.raises(err, match="max_new"):
            b.submit([1.0], 0)
        with pytest.raises(err, match="capacity"):
            b.submit(np.zeros(20), 20)
        with pytest.raises(err, match="stop_seq"):
            b.submit([1.0], 4, stop_seq=[0, VOCAB])
        with pytest.raises(err, match="paged"):
            b.register_prefix(np.zeros(16))
        with pytest.raises(err, match="stream"):
            b.drain_tokens()
        p = cls(srv, slots=2, capacity=64, paged=True, page_size=4,
                pool_pages=3)
        with pytest.raises(err, match="pool"):
            p.submit(np.zeros(10), 10)   # ceil(19 / 4) = 5 > 3 pages
        with pytest.raises(err, match="page"):
            p.register_prefix(np.zeros(3))
        with pytest.raises(err, match="not registered"):
            p.release_prefix(np.zeros(8))


def test_request_metrics():
    _, tsrv = _servers()
    b = ContinuousBatcher(tsrv, slots=2, capacity=64, paged=True,
                          page_size=4, pool_pages=5)
    rids = [b.submit(p, 8) for p in _prompts(10, (9, 8))]
    b.run()
    m = b.request_metrics()
    assert sorted(r["rid"] for r in m) == sorted(rids)
    for r in m:
        assert r["generated_tokens"] == 8
        assert 0 < r["ttft_s"] <= r["latency_s"]
    assert r["prompt_tokens"] in (9, 8)
    assert sum(r["preemptions"] for r in m) == b.stats["preemptions"] > 0
    assert b.request_metrics(reset=True) and not b.request_metrics()


def test_self_draft_accepts_everything_and_counts_rounds():
    """The target as its own draft: every proposal is accepted, so each
    round emits spec_k + 1 tokens: 8 tokens after admission per request
    at 3 a round, both requests at once, is 3 rounds (the JAX package's
    count; it also shows the draft's write-only step leaves no hole)."""
    prompts = _prompts(28, (6, 9))
    jax_streams, streams, jax_stats, stats, _ = _run_both(
        PLAIN, None, dict(draft="self", spec_k=2), prompts, [9, 9])
    solo = _solo(_servers()[1], prompts, [9, 9])
    for got, want, alone in zip(streams, jax_streams, solo):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, alone)
    assert shared(stats) == jax_stats
    assert stats["spec_rounds"] == 3 and stats["spec_emitted"] == 16


@pytest.mark.parametrize("mode", ["draft", "lookup"])
def test_speculative_with_prefix_and_stops_matches_jax(mode):
    """A registered prefix, a stop token and a stop sequence finishing
    rows in the middle of a round, through kernel B7's plain version."""
    rng = np.random.default_rng(29)
    system = rng.integers(0, VOCAB, 16).astype(np.float32)
    prompts = [np.concatenate([system, p]) for p in _prompts(30, (6, 4))]
    ref = _solo(_servers()[1], prompts, [12, 12])
    stop = int(ref[0][3])
    stop_seq = [int(t) for t in ref[1][4:6]]
    jsrv, tsrv = _servers()
    kw = (dict(draft="draft") if mode == "draft" else dict(lookup=True))
    got = []
    for i, (cls, srv) in enumerate(((JaxBatcher, jsrv),
                                    (ContinuousBatcher, tsrv))):
        if mode == "draft":
            kw["draft"] = _drafts()[i]
        b = cls(srv, slots=2, capacity=64, spec_k=4, paged=True,
                page_size=8, attention="flash", stop_token=stop, **kw)
        b.register_prefix(system)
        rids = [b.submit(prompts[0], 12), b.submit(prompts[1], 12,
                                                   stop_seq=stop_seq)]
        done = b.run()
        got.append(([done[r] for r in rids], b.stats))
    (want, want_stats), (streams, stats) = got
    for a, b_, r in zip(streams, want, ref):
        np.testing.assert_array_equal(a, b_)
        np.testing.assert_array_equal(a, r[:len(a)])
        assert len(a) < 12
    assert shared(stats) == want_stats and stats["prefix_hits"] == 2
    assert stats["free_pages"] == stats["pool_pages"] - 2


def test_sampled_speculative_rounds_hold_the_target_distribution():
    """Sampled rounds implement the rejection scheme: over 250 seeds the
    first two tokens' joint matches the target's p(t1) p(t2 | t1) (an
    untrained target and draft, so the correction draw fires often),
    within 0.09 (tests/test_serve.py's bound).  A seed gives the same
    tokens twice."""
    vocab = 6
    model = egt.compile(flash_transformer(vocab=vocab, dim=16, heads=2,
                                          max_seq=32), seed=0, device="cpu")
    target = FlashLMServer(model)
    draft = FlashLMServer(egt.compile(
        flash_transformer(vocab=vocab, dim=8, heads=2, max_seq=32), seed=3,
        device="cpu"))
    prompt = np.asarray([1, 2, 3, 4], np.float32)
    p1 = model.call("predict", {"tokens": prompt[None]})[0, -1].astype(
        np.float64)
    p1 /= p1.sum()
    joint = np.zeros((vocab, vocab))
    for t1 in range(vocab):
        ext = np.concatenate([prompt, [t1]])[None].astype(np.float32)
        p2 = model.call("predict", {"tokens": ext})[0, -1].astype(np.float64)
        joint[t1] = p1[t1] * p2 / p2.sum()

    def run(seed, n=2):
        b = ContinuousBatcher(target, slots=1, capacity=32, draft=draft,
                              spec_k=2, temperature=1.0, seed=seed)
        rid = b.submit(prompt, n)
        return b.run()[rid]

    n = 250
    emp = np.zeros((vocab, vocab))
    for s in range(n):
        emp[tuple(run(s))] += 1
    emp /= n
    assert np.abs(emp - joint).max() < 0.09, np.abs(emp - joint).max()
    np.testing.assert_array_equal(run(7, 6), run(7, 6))


def test_lookup_accepts_on_periodic_continuation_like_jax():
    """An untrained model's greedy output falls into short cycles, the
    regime lookup serves: the JAX package's pinned run (30 tokens after
    admission in at most 20 rounds), with equal streams and stats."""
    kw = dict(vocab=32, dim=16, heads=2, max_seq=96)
    ref = eg.compile(jax_transformer(**kw), backend="jax", seed=0)
    port = egt.compile(flash_transformer(**kw), seed=0, device="cpu")
    prompts = [np.random.default_rng(58).integers(0, 32, n).astype(
        np.float32) for n in (8, 5)]
    got = []
    for cls, srv in ((JaxBatcher, JaxServer(ref)),
                     (ContinuousBatcher, FlashLMServer(port))):
        b = cls(srv, slots=2, capacity=96, lookup=True, spec_k=4)
        rids = [b.submit(p, 16) for p in prompts]
        done = b.run()
        got.append(([done[r] for r in rids], b.stats))
    (want, want_stats), (streams, stats) = got
    for a, b_ in zip(streams, want):
        np.testing.assert_array_equal(a, b_)
    solo = _solo(FlashLMServer(port), prompts, [16, 16])
    for a, s in zip(streams, solo):
        np.testing.assert_array_equal(a, s)
    assert shared(stats) == want_stats
    assert stats["spec_emitted"] == 30 and stats["spec_rounds"] <= 20


def test_spec_margin_counts_in_paged_feasibility():
    """The paged feasibility bound counts the spec_k rows a round writes
    past the fed position, and the draft's max_seq must cover the
    capacity — alike in both packages."""
    jsrv, tsrv = _servers()
    for i, (cls, srv, err) in enumerate((
            (JaxBatcher, jsrv, eg.ModelRuntimeError),
            (ContinuousBatcher, tsrv, ModelRuntimeError))):
        draft = _drafts()[i]
        b = cls(srv, slots=2, capacity=64, paged=True, page_size=16,
                pool_pages=2, draft=draft, spec_k=4)
        # 20 + 13 - 1 + 4 = 36 rows -> 3 pages > a 2-page pool
        with pytest.raises(err, match="unpinned"):
            b.submit(np.zeros(20), 13)
        b.submit(np.zeros(20), 9)     # 32 rows: 2 pages
        lb = cls(srv, slots=2, capacity=64, paged=True, page_size=16,
                 pool_pages=2, lookup=True, spec_k=4)
        with pytest.raises(err, match="unpinned"):
            lb.submit(np.zeros(20), 13)
    short = egt.compile(flash_transformer(vocab=VOCAB, dim=16, heads=2,
                                          max_seq=32), seed=2, device="cpu")
    with pytest.raises(ModelRuntimeError, match="DRAFT"):
        ContinuousBatcher(tsrv, slots=2, capacity=64,
                          draft=FlashLMServer(short), spec_k=4)


def test_speculative_validation_matches_jax():
    jsrv, tsrv = _servers()
    for i, (cls, srv, err) in enumerate((
            (JaxBatcher, jsrv, eg.ModelRuntimeError),
            (ContinuousBatcher, tsrv, ModelRuntimeError))):
        draft = _drafts()[i]
        small = (JaxServer(eg.compile(jax_transformer(
            vocab=16, dim=16, heads=2, max_seq=64), seed=1)) if i == 0
            else FlashLMServer(egt.compile(flash_transformer(
                vocab=16, dim=16, heads=2, max_seq=64), seed=1,
                device="cpu")))
        cases = [
            ("top_k", dict(draft=draft, temperature=0.5, top_k=4)),
            ("decode_chunk", dict(draft=draft, decode_chunk=4)),
            ("vocab", dict(draft=small)),
            ("spec_k", dict(draft=draft, spec_k=0)),
            ("mutually exclusive", dict(lookup=True, draft=draft)),
            ("greedy", dict(lookup=True, temperature=0.5)),
            ("decode_chunk", dict(lookup=True, decode_chunk=4)),
            ("speculation", dict(lookup=True, pipeline=1)),
            ("lookup_ngram", dict(lookup=True, lookup_ngram=0)),
        ]
        for match, kw in cases:
            with pytest.raises(err, match=match):
                cls(srv, slots=2, capacity=64, **kw)
        b = cls(srv, slots=2, capacity=64, draft=draft, spec_k=4)
        with pytest.raises(err, match="capacity"):
            b.submit(np.zeros(30), 32)      # 30 + 32 - 1 + 4 > 64
        with pytest.raises(err, match="per-request"):
            b.submit(np.zeros(4), 4, temperature=0.5)
        lb = cls(srv, slots=2, capacity=64, lookup=True)
        with pytest.raises(err, match="overrides"):
            lb.submit(np.zeros(4, np.float32), 4, temperature=0.7)
        with pytest.raises(err, match="spec_k"):
            lb.submit(np.zeros(60, np.float32), 4)


def test_batcher_over_tensor_parallel_mesh(tmp_path):
    """The scheduler over a (1, 2)-mesh server of gloo ranks: each rank's
    paged pool holds its kv head, the paged attention runs on the local
    heads (its plain version here), and with decode_chunk=2 (eager on
    the CPU) every stream equals solo serving and the JAX batcher over
    its own tensor-parallel server (tests/test_batcher.py's mesh case)."""
    from exprgrad_tpu.parallel import make_mesh as jax_mesh

    from test_torch_parallel import _jax_state, _w_serve
    from test_torch_spawn import run_world

    ref, port = _models()
    prompts = _prompts(25, (5, 9, 3))
    max_new = [6, 4, 8]
    refs = _solo(FlashLMServer(port), prompts, max_new)
    jb = JaxBatcher(JaxServer(ref, mesh=jax_mesh(8, model=2)), slots=2,
                    capacity=64, paged=True, page_size=8, decode_chunk=2)
    jrids = [jb.submit(p, mn) for p, mn in zip(prompts, max_new)]
    jdone = jb.run()
    bkw = dict(slots=2, capacity=64, paged=True, page_size=8,
               decode_chunk=2)
    kw = dict(vocab=VOCAB, dim=16, heads=2, max_seq=64, window=None,
              rope=False)
    res = run_world(tmp_path, _w_serve, 2, (1, 2), "flash_transformer", kw,
                    _jax_state(ref), {},
                    [("batcher", prompts, (max_new, bkw))])
    for rank in range(2):
        (streams, stats), = res[rank][0]
        for got, solo, rid in zip(streams, refs, jrids):
            np.testing.assert_array_equal(got, solo)
            np.testing.assert_array_equal(got, np.asarray(jdone[rid]))
        assert stats["free_pages"] == stats["pool_pages"]
    assert res[0][1]["heads"] == (1, 1)
