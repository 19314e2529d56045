"""Port parity: continuous batching for encoder-decoder serving
(``Seq2SeqBatcher`` in exprgrad_torch/models/batcher.py).

The JAX package's tests/test_seq2seq_batcher.py, run on the port, beside
the JAX package's batcher on the same weights (a tiny_seq2seq trained
three steps to copy its source, carried over with ``egt.from_state``)
and the same sources:

* greedy streams, with slot reuse, equal each source served alone
  (``Seq2SeqServer.generate``) and the JAX batcher's streams and stats;
* ``stop_token`` and ``stop_seq`` end requests mid-stream, also mid
  lookup round; streaming hands out the same tokens;
* ``lookup=True`` gives the same streams in fewer rounds than tokens;
* per-request sampling: ``top_k=1`` rows equal greedy, seeded runs
  repeat (single draws are not compared with ``jax.random``'s);
* the refusals raise the same error types.
"""

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_tpu as eg
import exprgrad_tpu.models as jm
from exprgrad_torch.errors import ModelRuntimeError
from exprgrad_torch.models import Seq2SeqBatcher, Seq2SeqServer, tiny_seq2seq

VOCAB = 8
SIZE = dict(vocab=VOCAB, dim=16, max_src=16, max_tgt=16)


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) over one set of weights."""
    ref = eg.compile(jm.tiny_seq2seq(**SIZE), backend="jax", seed=1)
    rng = np.random.default_rng(1)
    src = rng.integers(0, VOCAB, (8, 8)).astype(np.float32)
    tgt = np.concatenate([np.zeros((8, 1)), src[:, :-1]], 1).astype(
        np.float32)
    labels = np.eye(VOCAB, dtype=np.float32)[src.astype(int)]
    for _ in range(3):
        ref.epoch += 1
        ref.apply("train", {"src": src, "tgt": tgt, "labels": labels})
    port = egt.from_state(tiny_seq2seq(**SIZE), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")
    return jm.Seq2SeqServer(ref), Seq2SeqServer(port)


def _solo(server, srcs, max_new):
    return [np.asarray(server.generate(s[None, :], n_new=mn,
                                       lengths=[s.size]))[0]
            for s, mn in zip(srcs, max_new)]


def _drive(cls, server, srcs, max_new, **kw):
    b = cls(server, slots=2, max_src=16, capacity=16, **kw)
    rids = [b.submit(s, mn) for s, mn in zip(srcs, max_new)]
    done = b.run()
    return [done[r] for r in rids], b.stats


def _srcs(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype(np.float32) for n in lens]


@pytest.mark.parametrize("lookup", [False, True])
def test_greedy_streams_equal_solo_and_jax(servers, lookup):
    jsrv, tsrv = servers
    srcs = _srcs(2 if not lookup else 11, (6, 11, 4, 9))
    max_new = [7, 5, 9, 6]
    solo = _solo(tsrv, srcs, max_new)
    for got, want in zip(solo, _solo(jsrv, srcs, max_new)):
        np.testing.assert_array_equal(got, want)
    kw = dict(lookup=True, spec_k=4) if lookup else {}
    got, stats = _drive(Seq2SeqBatcher, tsrv, srcs, max_new, **kw)
    want, jstats = _drive(jm.Seq2SeqBatcher, jsrv, srcs, max_new, **kw)
    for g, w, s in zip(got, want, solo):
        np.testing.assert_array_equal(g, s.astype(np.int64))
        np.testing.assert_array_equal(g, w)
    assert stats == jstats
    assert stats["decode_steps"] <= sum(max_new)
    if lookup:
        assert stats["spec_rounds"] == stats["dispatches"]
        assert stats["spec_rounds"] < stats["spec_emitted"], stats
    else:
        assert stats["decode_steps"] < sum(max_new)


@pytest.mark.parametrize("lookup", [False, True])
def test_stop_token_mid_stream_and_streaming(servers, lookup):
    _, tsrv = servers
    srcs = _srcs(3 if not lookup else 12, (6, 9))
    ref = _solo(tsrv, srcs, [10, 10])
    stop = int(ref[0][2])
    b = Seq2SeqBatcher(tsrv, slots=2, max_src=16, capacity=16,
                       stop_token=stop, stream_tokens=True, lookup=lookup)
    rids = [b.submit(s, 10) for s in srcs]
    streamed = {rid: [] for rid in rids}
    done = {}
    while len(done) < 2:
        for rid, toks in b.step():
            done[rid] = toks
        for rid, tok in b.drain_tokens():
            streamed[rid].append(tok)
    for rid, r in zip(rids, ref):
        got = done[rid]
        r64 = r.astype(np.int64)
        np.testing.assert_array_equal(got, r64[:len(got)])
        np.testing.assert_array_equal(np.asarray(streamed[rid], np.int64),
                                      got)
        if stop in r64:
            assert got[-1] == stop
            assert len(got) == list(r64).index(stop) + 1
    metrics = b.request_metrics()
    assert len(metrics) == 2 and all(r["ttft_s"] > 0 for r in metrics)


def test_per_request_stop_seq(servers):
    _, tsrv = servers
    srcs = _srcs(7, (6, 9))
    ref = _solo(tsrv, srcs, [10, 10])
    seq = [int(ref[0][1]), int(ref[0][2])]
    b = Seq2SeqBatcher(tsrv, slots=2, max_src=16, capacity=16)
    rids = [b.submit(srcs[0], 10, stop_seq=seq), b.submit(srcs[1], 10)]
    done = b.run()
    got0 = done[rids[0]]
    assert len(got0) == 3 and list(got0[-2:]) == seq
    np.testing.assert_array_equal(got0, ref[0][:3].astype(np.int64))
    np.testing.assert_array_equal(done[rids[1]], ref[1].astype(np.int64))


def test_per_request_sampling(servers):
    _, tsrv = servers
    srcs = _srcs(4, (5, 8, 6))
    refs = _solo(tsrv, srcs[:2], [6, 6])

    def drive(seed):
        b = Seq2SeqBatcher(tsrv, slots=3, max_src=16, capacity=16,
                           seed=seed)
        r0 = b.submit(srcs[0], 6)                            # greedy
        r1 = b.submit(srcs[1], 6, temperature=0.8, top_k=1)  # == greedy
        r2 = b.submit(srcs[2], 6, temperature=1.1, top_p=0.9)
        done = b.run()
        return done[r0], done[r1], done[r2]

    d0, d1, d2 = drive(5)
    np.testing.assert_array_equal(d0, refs[0].astype(np.int64))
    np.testing.assert_array_equal(d1, refs[1].astype(np.int64))
    assert d2.shape == (6,) and d2.min() >= 0 and d2.max() < VOCAB
    np.testing.assert_array_equal(drive(5)[2], d2)


def test_refusals_and_cancel_match_jax(servers):
    jsrv, tsrv = servers
    src = np.random.default_rng(5).integers(0, VOCAB, 6).astype(np.float32)
    for cls, srv, err in ((jm.Seq2SeqBatcher, jsrv, eg.ModelRuntimeError),
                          (Seq2SeqBatcher, tsrv, ModelRuntimeError)):
        b = cls(srv, slots=2, max_src=16, capacity=16)
        for args, kw, match in (
                (([], 4), {}, "empty"),
                ((np.zeros(40), 4), {}, "max_src"),
                ((np.zeros(4), 100), {}, "capacity"),
                ((np.zeros(4), 0), {}, "max_new"),
                ((src, 4), dict(stop_seq=[VOCAB]), "stop_seq"),
                ((src, 4), dict(top_k=0), "top_k"),
                ((src, 4), dict(top_p=1.5), "top_p")):
            with pytest.raises(err, match=match):
                b.submit(*args, **kw)
        for kw, match in ((dict(max_src=999), "max_src"),
                          (dict(capacity=999), "capacity"),
                          (dict(spec_k=0), "spec_k"),
                          (dict(lookup=True, temperature=0.5), "greedy"),
                          (dict(lookup=True, lookup_ngram=0),
                           "lookup_ngram")):
            with pytest.raises(err, match=match):
                cls(srv, slots=2, **kw)
        lk = cls(srv, slots=2, capacity=16, lookup=True, spec_k=4)
        with pytest.raises(err, match="spec_k"):
            lk.submit(np.zeros(4, np.float32), 14)  # 14 + 4 > 16
        with pytest.raises(err, match="overrides"):
            lk.submit(np.zeros(4, np.float32), 4, temperature=0.3)
        with pytest.raises(err, match="streaming"):
            b.drain_tokens()
        r0 = b.submit(src, 12)
        r1 = b.submit(src, 5)
        r2 = b.submit(src, 5)
        b.step()
        assert b.cancel(r0) and b.cancel(r2) and not b.cancel(99)
        assert set(b.run()) == {r1}
        assert not b.cancel(r1)
    assert isinstance(tsrv, Seq2SeqServer)
    assert Seq2SeqBatcher(tsrv, slots=1).caches[0].k.dtype == torch.float32
