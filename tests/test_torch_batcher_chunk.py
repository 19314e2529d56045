"""Port parity: multi-step and pipelined decode in the continuous batcher
(``ContinuousBatcher(decode_chunk=N, pipeline=P)``,
exprgrad_torch/models/batcher.py).

The JAX package's tests of these options (tests/test_batcher.py's
multi-step and pipelined sections, ``test_chunked_prefill_with_prefix_
and_decode_chunk``, tests/test_paged_attention.py's
``test_flash_batcher_decode_chunk``) run through both packages on the
same trained weights, on the CPU, where the port runs a chunk's steps
eagerly (on the card a chunk is one CUDA graph replay, held by
chip_smoke.py's phase 20).  Float32 greedy streams must be equal token
for token between the packages and equal to the port's solo
``generate``; the scheduler's ``stats`` (decode steps, dispatches,
preemptions, free pages, window evictions, prefix hits; the port's own
prefill and decode token counts aside) must be equal.
Beyond the JAX package's tests: a windowed model under ``pipeline=1``
(its streams equal ``pipeline=0``'s), the page reservation of a windowed
model with ``decode_chunk=16`` on a tight pool, the option checks'
messages, and sampled chunks reproducible under a seed.
"""

import numpy as np
import pytest

import exprgrad_tpu as eg
from exprgrad_torch import ModelRuntimeError
from exprgrad_torch.models import ContinuousBatcher
from tests.test_torch_batcher import (VOCAB, JaxBatcher, _drafts, _prompts,
                                      _run_both, _servers, _solo, shared)

PLAIN, WINDOW = (None, False), (8, False)


def _held(model, cache, kw, prompts, max_new, prefix=None, positive=None):
    """Both packages' streams and stats equal, the port's streams equal
    solo generate; returns the port's stats."""
    jax_streams, streams, jax_stats, stats, _ = _run_both(
        model, cache, kw, prompts, max_new, prefix=prefix)
    solo = _solo(_servers(*model, cache)[1], prompts, max_new)
    for got, want, ref in zip(streams, jax_streams, solo):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    assert shared(stats) == jax_stats, (stats, jax_stats)
    if positive is not None:
        assert stats[positive] > 0, stats
    return stats


# (id, model, cache dtype, batcher kwargs, prompt sizes, budgets, seed,
#  a stat that must be > 0)
CASES = [
    # test_batcher.py::test_chunked_decode_matches_solo
    ("chunk_dense", PLAIN, None, dict(decode_chunk=4), (5, 9, 3, 12),
     (6, 4, 8, 5), 16, None),
    ("chunk_paged", PLAIN, None, dict(decode_chunk=4, paged=True,
                                      page_size=4), (5, 9, 3, 12),
     (6, 4, 8, 5), 16, None),
    # test_paged_attention.py::test_flash_batcher_decode_chunk
    ("chunk_flash", PLAIN, None,
     dict(decode_chunk=4, paged=True, page_size=8, attention="flash"),
     (7, 4), (9, 6), 23, None),
    ("chunk_int8_flash", PLAIN, "int8",
     dict(decode_chunk=5, paged=True, page_size=8, attention="flash"),
     (7, 4, 10), (9, 6, 12), 24, None),
    ("chunk_preemption_flash", PLAIN, "float32",
     dict(decode_chunk=3, paged=True, page_size=8, pool_pages=3,
          attention="flash"), (9, 8), (8, 8), 10, "preemptions"),
    ("chunk_window_eviction", WINDOW, None,
     dict(decode_chunk=4, paged=True, page_size=4), (20, 6), (30, 40), 31,
     "window_evicted"),
    # test_batcher.py::test_pipelined_decode_matches_solo
    ("pipe_dense", PLAIN, None, dict(decode_chunk=4, pipeline=2),
     (5, 9, 3, 12, 6), (6, 14, 8, 5, 11), 26, None),
    ("pipe_paged", PLAIN, None,
     dict(decode_chunk=4, pipeline=2, paged=True, page_size=4),
     (5, 9, 3, 12, 6), (6, 14, 8, 5, 11), 26, None),
    ("pipe_flash", PLAIN, None,
     dict(decode_chunk=4, pipeline=2, paged=True, page_size=8,
          attention="flash"), (5, 9, 3, 12, 6), (6, 14, 8, 5, 11), 26,
     None),
    # test_batcher.py::test_pipelined_tight_pool_falls_back
    ("pipe_tight_pool", PLAIN, None,
     dict(decode_chunk=4, pipeline=2, paged=True, page_size=4,
          pool_pages=9), (6, 5, 7), (10, 9, 8), 28, None),
]


@pytest.mark.parametrize(
    "model,cache,kw,sizes,max_new,seed,positive",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_streams_and_stats_match_jax_and_solo(model, cache, kw, sizes,
                                              max_new, seed, positive):
    stats = _held(model, cache, kw, _prompts(seed, sizes), max_new,
                  positive=positive)
    chunk = kw["decode_chunk"]
    if "pipeline" not in kw:
        assert stats["dispatches"] * chunk == stats["decode_steps"], stats
    if kw.get("paged"):
        assert stats["free_pages"] == stats["pool_pages"], stats


def test_chunked_with_prefix_and_tight_pool():
    """test_batcher.py::test_chunked_with_prefix_and_tight_pool: chunked
    decode composes with prefix caching and preemption."""
    rng = np.random.default_rng(17)
    system = rng.integers(0, VOCAB, 16).astype(np.float32)
    prompts = [np.concatenate([system, p])
               for p in (rng.integers(0, VOCAB, n).astype(np.float32)
                         for n in (6, 5))]
    _held(PLAIN, None, dict(paged=True, page_size=4, pool_pages=10,
                            decode_chunk=3), prompts, [8, 8], prefix=system,
          positive="prefix_hits")


def test_chunked_prefill_with_prefix_and_decode_chunk():
    """test_batcher.py::test_chunked_prefill_with_prefix_and_decode_chunk:
    a pinned prefix, chunked prefill of the rest and multi-step decode on
    a tight pool."""
    rng = np.random.default_rng(20)
    system = rng.integers(0, VOCAB, 16).astype(np.float32)
    prompts = [np.concatenate([system, p])
               for p in (rng.integers(0, VOCAB, n).astype(np.float32)
                         for n in (21, 9))]
    _held(PLAIN, None, dict(paged=True, page_size=4, prefill_chunk=8,
                            decode_chunk=3, pool_pages=12), prompts, [6, 8],
          prefix=system, positive="prefix_hits")


def _stop_case(kw, seed, sizes):
    """Both packages under a stop token taken from the first request's
    solo stream: each stream is its solo stream cut at the stop, and the
    streams and stats of the packages are equal."""
    jsrv, tsrv = _servers()
    prompts = _prompts(seed, sizes)
    ref = _solo(tsrv, prompts, [12] * len(prompts))
    stop = int(ref[0][2])
    out = []
    for cls, srv in ((JaxBatcher, jsrv), (ContinuousBatcher, tsrv)):
        b = cls(srv, slots=2, capacity=64, stop_token=stop, **kw)
        rids = [b.submit(p, 12) for p in prompts]
        done = b.run()
        out.append(([np.asarray(done[r]) for r in rids], b.stats))
    (jax_streams, jax_stats), (streams, stats) = out
    for got, want, r in zip(streams, jax_streams, ref):
        np.testing.assert_array_equal(got, want)
        if stop in r[:len(got)]:
            assert got[-1] == stop
        np.testing.assert_array_equal(got, r[:len(got)])
    assert shared(stats) == jax_stats
    return stats


def test_chunked_stop_token():
    """test_batcher.py::test_chunked_stop_token: a stop fires mid-chunk;
    the chunk's surplus tokens are dropped and the slot frees."""
    _stop_case(dict(decode_chunk=5), 18, (5, 7, 4))


def test_pipelined_stop_token_mid_chunk():
    """test_batcher.py::test_pipelined_stop_token_mid_chunk: a stop while
    later chunks are in flight; the slot is released only after the pipe
    drains, and every page comes back."""
    stats = _stop_case(dict(decode_chunk=3, pipeline=3, paged=True,
                            page_size=4), 27, (5, 7, 4, 8))
    assert stats["free_pages"] == stats["pool_pages"]


def _drive(cls, srv, kw, prompts, max_new, steps, late=None):
    """Submit the prompts, run ``steps`` step() calls, submit ``late``
    (prompt, budget) then, and run to the end; returns (streams of every
    request in submission order, batcher)."""
    b = cls(srv, slots=2, capacity=64, **kw)
    rids = [b.submit(p, m) for p, m in zip(prompts, max_new)]
    out = {}
    for _ in range(steps):
        out.update(dict(b.step()))
    if late is not None:
        rids.append(b.submit(*late))
    out.update(b.run())
    return [out[r] for r in rids], b


def test_pipelined_cancel_mid_flight():
    """test_batcher.py::test_pipelined_cancel_mid_flight: cancel() with
    dispatches in flight drains the pipe first; the other request still
    matches solo, and every page comes back."""
    jsrv, tsrv = _servers()
    prompts = _prompts(29, (5, 8))
    solo = _solo(tsrv, prompts, [20, 20])
    kw = dict(paged=True, page_size=4, decode_chunk=4, pipeline=2)
    stats = []
    for cls, srv in ((JaxBatcher, jsrv), (ContinuousBatcher, tsrv)):
        b = cls(srv, slots=2, capacity=64, **kw)
        r0, r1 = (b.submit(p, 20) for p in prompts)
        out = {}
        for _ in range(2):
            out.update(dict(b.step()))
        assert b._pipe  # dispatches in flight
        assert b.cancel(r0)
        out.update(b.run())
        assert r0 not in out
        np.testing.assert_array_equal(out[r1], solo[1])
        assert b.stats["free_pages"] == b.stats["pool_pages"]
        stats.append(b.stats)
    assert stats[0] == shared(stats[1])


def test_pipelined_admission_waits_for_drain():
    """test_batcher.py::test_pipelined_admission_waits_for_drain: a
    submission mid-pipeline drains before its admission; every stream
    matches solo and the JAX package's."""
    jsrv, tsrv = _servers()
    prompts = _prompts(30, (4, 6, 9))
    max_new = [8, 18, 7]
    solo = _solo(tsrv, prompts, max_new)
    kw = dict(decode_chunk=3, pipeline=2)
    got = [_drive(cls, srv, kw, prompts[:2], max_new[:2], 2,
                  late=(prompts[2], max_new[2]))
           for cls, srv in ((JaxBatcher, jsrv), (ContinuousBatcher, tsrv))]
    (jax_streams, jb), (streams, b) = got
    for s, j, ref in zip(streams, jax_streams, solo):
        np.testing.assert_array_equal(s, j)
        np.testing.assert_array_equal(s, ref)
    assert shared(b.stats) == jb.stats


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_windowed_pipeline_equals_unpipelined(paged):
    """A sliding-window model under pipeline=1 (which the JAX package's
    tests never ran): window eviction runs during a drain while the next
    dispatch is in flight with a page table that still maps the evicted
    pages.  The streams equal pipeline=0's, the JAX package's and solo
    generate's, and every page comes back."""
    prompts = _prompts(41, (20, 6, 13))
    max_new = [30, 40, 25]
    kw = dict(decode_chunk=8, paged=True, page_size=4) if paged else dict(
        decode_chunk=8)
    piped = _held(WINDOW, None, dict(kw, pipeline=1), prompts, max_new)
    flat = _held(WINDOW, None, kw, prompts, max_new)
    if paged:
        assert piped["window_evicted"] > 0, piped
        assert piped["free_pages"] == piped["pool_pages"], piped
        assert flat["window_evicted"] > 0, flat


def test_window_margin_counts_the_decode_chunk():
    """The worst-case page reservation of a windowed model counts a decode
    chunk as a burst of writes between window evictions (the JAX
    package's ``margin``).  With ``decode_chunk=16``, longer than the
    implicit admission chunk of 12, both packages reserve the same pages
    (window 8 + 16 + 1 rows: 7 pages, and 2 more), refuse the same
    request on a pool of 8, and serve the same streams with the same
    stats on a pool of 9."""
    jsrv, tsrv = _servers(8, False)
    kw = dict(slots=2, capacity=64, paged=True, page_size=4, pool_pages=9,
              decode_chunk=16)
    tokens = np.zeros(30, np.float32)
    own = []
    for cls, srv, err in ((JaxBatcher, jsrv, eg.ModelRuntimeError),
                          (ContinuousBatcher, tsrv, ModelRuntimeError)):
        b = cls(srv, **kw)
        own.append([b._own_pages_needed(tokens, m) for m in (1, 10, 34)])
        with pytest.raises(err, match="unpinned"):
            cls(srv, **dict(kw, pool_pages=8)).submit(tokens, 34)
    assert own[0] == own[1] == [8, 9, 9], own
    _held(WINDOW, None, dict(paged=True, page_size=4, pool_pages=9,
                             decode_chunk=16), _prompts(42, (30, 9)),
          [34, 40], positive="window_evicted")


def test_validation_matches_jax():
    """Every combination the JAX package accepts constructs on the port,
    and every one it refuses the port refuses with the same message."""
    jsrv, tsrv = _servers()
    bad = [dict(pipeline=-1, decode_chunk=4), dict(pipeline=2),
           dict(decode_chunk=0), dict(pipeline=1, decode_chunk=1),
           dict(lookup=True, pipeline=1, decode_chunk=4),
           dict(draft="draft", decode_chunk=4),
           dict(draft="draft", pipeline=1),
           dict(lookup=True, decode_chunk=2)]
    good = [dict(decode_chunk=2), dict(decode_chunk=4, pipeline=1),
            dict(decode_chunk=8, pipeline=3, paged=True, page_size=8,
                 attention="flash"),
            dict(decode_chunk=3, paged=True, page_size=4, prefill_chunk=8)]
    for i, (cls, srv, err) in enumerate((
            (JaxBatcher, jsrv, eg.ModelRuntimeError),
            (ContinuousBatcher, tsrv, ModelRuntimeError))):
        for kw in good:
            b = cls(srv, slots=2, capacity=64, **kw)
            assert (b.decode_chunk, b.pipeline) == (
                kw["decode_chunk"], kw.get("pipeline", 0))
    messages = []
    for kw in bad:
        said = []
        for i, (cls, srv, err) in enumerate((
                (JaxBatcher, jsrv, eg.ModelRuntimeError),
                (ContinuousBatcher, tsrv, ModelRuntimeError))):
            kw_i = dict(kw)
            if kw_i.get("draft") == "draft":
                kw_i["draft"] = _drafts()[i]
            with pytest.raises(err) as info:
                cls(srv, slots=2, capacity=64, **kw_i)
            said.append(str(info.value))
        assert said[0] == said[1], (kw, said)
        messages.append(said[1])
    assert "pipeline" in messages[0] and "decode_chunk" in messages[1]


def test_sampled_chunks_are_seeded():
    """Sampled rows in chunk dispatches (``jax.random`` cannot be matched
    in torch): the same seed gives the same streams, dense and paged,
    pipelined or not; another seed gives others; every token lies in the
    vocabulary and greedy rows beside sampled ones keep their solo
    streams."""
    _, tsrv = _servers()
    prompts = _prompts(43, (5, 9, 7))
    solo = _solo(tsrv, prompts, [12, 12, 12])

    def drive(seed, **kw):
        b = ContinuousBatcher(tsrv, slots=3, capacity=64, seed=seed,
                              decode_chunk=4, **kw)
        rids = [b.submit(prompts[0], 12, temperature=0.9, top_k=8),
                b.submit(prompts[1], 12),
                b.submit(prompts[2], 12, temperature=1.2, top_p=0.8)]
        done = b.run()
        return [done[r] for r in rids]

    for kw in (dict(), dict(pipeline=2, paged=True, page_size=4)):
        a, b, c = drive(3, **kw), drive(3, **kw), drive(4, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert any(not np.array_equal(x, y) for x, y in zip(a, c))
        for s in a + c:
            assert s.shape == (12,) and ((s >= 0) & (s < VOCAB)).all()
        np.testing.assert_array_equal(a[1], solo[1])
        np.testing.assert_array_equal(c[1], solo[1])
