"""The hybrid Jamba model on the port (``models/jamba.py``), on the CPU at
a small size (dim 64, 4 heads and 2 KV heads of 16, 4 experts top-2,
d_state 16, d_conv 4, dt_rank 8, one period of 8 layers, vocab 97)
against the plain reference ``tests/jamba_reference.py``: the DSL's
predict and train through the executor (the externs ``mamba``,
``moe_swiglu`` and their gradients), ``FlashLMServer``'s prefill and
decode through the caches, ``ContinuousBatcher`` with ragged prompts in
padded buckets, slot reuse and preemption, the Mamba kernels' plain
twins, routed against dense-masked experts, the refusals, the spans and
counters, and a dense model's stats left as they were.

Tolerances, each with its reason: float64 programs against the float64
reference at 1e-10 (the same operations in another order, one rounding
step of 1e-16 a sum); float32 at 2e-5 on probabilities and 1e-4 on
logits (float32 sums of up to 256 terms in other orders, carried through
a 12-step recurrence and the softmax); a served stream is exact (greedy
tokens equal the server's solo stream, the same operations on the same
rows); and a served token's reference logit lies within 1e-4 of the
reference's best (float32 logits of order 1).
"""

import filecmp
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import jamba_reference as ref
from exprgrad_torch import tracing
from exprgrad_torch.errors import ModelRuntimeError
from exprgrad_torch.layers import gradient_descent
from exprgrad_torch.models import (ContinuousBatcher, FlashLMServer,
                                   flash_transformer)
from exprgrad_torch.models.jamba import jamba_lm
from exprgrad_torch.ops import mamba, moe

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=8,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=97,
           rms_norm_eps=1e-6, num_experts=4, num_experts_per_tok=2,
           attn_layer_period=8, attn_layer_offset=4, expert_layer_period=2,
           expert_layer_offset=1, mamba_d_state=16, mamba_d_conv=4,
           mamba_expand=2, mamba_dt_rank=8)
BUILD = dict(vocab=97, dim=64, heads=4, kv_heads=2, hidden=96, layers=8,
             n_experts=4, k=2, d_state=16, d_conv=4, dt_rank=8, max_seq=64)
F64 = dict(rtol=1e-10, atol=1e-10)


def leaves(dtype=torch.float32, seed=0, scale=0.1):
    """Seeded weights in the program's order, with Mamba's own init:
    a_log = log(1..16), D = 1, unit gains, the step bias softplus^-1 of
    steps log-uniform in [0.001, 0.1]."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for name, shape in ref.layout(CFG):
        if name.endswith(("rms.g", "_norm")) or name == "mamba.d":
            v = torch.ones(shape, dtype=torch.float64)
        elif name == "mamba.a_log":
            v = torch.log(torch.arange(1.0, shape[1] + 1,
                                       dtype=torch.float64)).repeat(
                                           shape[0], 1)
        elif name == "mamba.dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(torch.rand(shape, generator=gen,
                                      dtype=torch.float64) * (hi - lo) + lo)
            v = dt + torch.log(-torch.expm1(-dt))
        else:
            v = (torch.rand(shape, generator=gen, dtype=torch.float64)
                 * 2 - 1) * scale
        out.append(v.to(dtype))
    return out


def compiled(dtype="float32", **kw):
    model = egt.compile(jamba_lm(**dict(BUILD, **kw)), seed=0, dtype=dtype,
                        device="cpu")
    w = leaves(getattr(torch, dtype))
    model.params = dict(zip(model.program.params, w))
    return model, ref.Weights(CFG, w)


@pytest.fixture(scope="module")
def f32():
    return compiled()


def tokens(n, t, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (n, t)).astype(
        np.float32)


def test_reference_copy_is_the_benchmarks():
    assert filecmp.cmp(ROOT / "tests" / "jamba_reference.py",
                       ROOT / "portbench" / "reference" / "jamba.py",
                       shallow=False)


def test_program_lays_out_one_period():
    model, _ = compiled()
    prog = model.program
    assert [(prog.tensors[t].name, tuple(prog.tensors[t].shape))
            for t in prog.params] == ref.layout(CFG)
    assert [k for k in ref.kinds(CFG)] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attention", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]
    assert "jamba_lm" not in egt.models.__all__


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_predict_matches_the_reference(dtype):
    model, w = compiled(dtype)
    toks = tokens(2, 12)
    got = np.asarray(model.call("predict", {"tokens": toks.astype(dtype)}))
    want = torch.softmax(ref.forward(w, torch.as_tensor(toks).long()),
                         dim=-1).numpy()
    tol = F64 if dtype == "float64" else dict(rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, **tol)
    stats = model.lowering_stats("predict")
    assert stats["extern:mamba"] == 7 and stats["extern:moe_swiglu"] == 4


def test_train_gradients_match_the_reference():
    """One gradient-descent step of rate 1 in float64: every parameter's
    change is minus its gradient, through mamba_grad and
    moe_swiglu_grad, against the reference's autograd of the loss.  The
    attention op keeps its softmax's log-sum-exp in float32 whatever the
    program's dtype (``ops.attention``), so a gradient that flows back
    through the attention layer (its own weights and every earlier
    layer's) agrees to 1e-6 of its largest entry (some ten float32
    roundings); the rest to 1e-10."""
    from exprgrad_torch import make_opt

    model, w = compiled("float64", opt=make_opt(gradient_descent, rate=1.0))
    before = [p.clone() for p in model.params.values()]
    toks = tokens(2, 10, seed=3)
    targets = np.roll(toks, -1, axis=1)
    labels = np.eye(97)[targets.astype(int)]
    model.apply("train", {"tokens": toks.astype(np.float64),
                          "labels": labels})
    params = [p.detach().clone().requires_grad_(True) for p in before]
    loss = ref.loss(ref.Weights(CFG, params), torch.as_tensor(toks).long(),
                    torch.as_tensor(targets).long())
    grads = torch.autograd.grad(loss, params)
    names = [name for name, _ in ref.layout(CFG)]
    through = names.index("wo")
    for i, (name, p0, p1, g) in enumerate(zip(
            names, before, model.params.values(), grads)):
        tol = (dict(rtol=0, atol=1e-6 * float(g.abs().max()))
               if i <= through else F64)
        np.testing.assert_allclose((p0 - p1).numpy(), g.numpy(), **tol,
                                   err_msg=name)
    stats = model.lowering_stats("train")
    # one extern kernel for each gradient an op writes: 13 a Mamba
    # layer, 5 an expert layer
    assert stats["extern:mamba_grad"] == 7 * 13
    assert stats["extern:moe_swiglu_grad"] == 4 * 5


def test_server_prefill_then_decode_matches_the_full_forward(f32):
    model, w = f32
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    assert srv.mixers.count("mamba") == 7 and srv.max_seq == 64
    toks = tokens(2, 12, seed=1)
    want = ref.forward(w, torch.as_tensor(toks).long()).detach()
    logits, caches = srv.prefill(toks[:, :7], srv.init_caches(2))
    got = [logits]
    for i in range(7, 12):
        logits, caches = srv.decode(toks[:, i:i + 1], caches)
        got.append(logits)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               rtol=0, atol=1e-4)


def test_ragged_generate_equals_each_prompt_alone(f32):
    model, _ = f32
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    toks = tokens(2, 9, seed=2)
    both = srv.generate(toks, n_new=5, lengths=[9, 4])
    for row, n in enumerate((9, 4)):
        alone = srv.generate(toks[row:row + 1, :n], n_new=5)
        np.testing.assert_array_equal(both[row].numpy(), alone[0].numpy())


def test_padding_leaves_the_state_as_the_true_length_does(f32):
    """A prompt right-padded to a bucket prefills to the state of the
    prompt alone (the conv window and the scan state of every layer)."""
    model, _ = f32
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    toks = tokens(1, 16, seed=4)
    lens = torch.tensor([11])
    pos, key_pos = srv._ragged_positions(lens, 16, 16)
    _, padded = srv._step(srv._embed_at(srv._tokens(toks), pos),
                          srv.init_caches(1, 16), 0, key_pos=key_pos,
                          q_pos=pos)
    _, alone = srv.prefill(toks[:, :11], srv.init_caches(1, 16))
    for kind, a, b in zip(srv.mixers, padded, alone):
        if kind == "mamba":
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                           atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(paged=True, page_size=4, pool_pages=40, attention="flash",
         decode_chunk=4),
    dict(paged=True, page_size=4, pool_pages=40, attention="gather"),
    dict(paged=True, page_size=4, pool_pages=5, decode_chunk=2),
    dict(paged=False),
    dict(paged=False, decode_chunk=3),
], ids=["flash-chunk4", "gather", "preempting", "dense", "dense-chunk3"])
def test_batcher_streams_equal_solo_and_the_reference(f32, kw):
    """Ragged prompts in padded buckets over 2 slots (each reused after
    a finish): every stream is the solo server's, and every served token
    is within 1e-4 of the reference's best logit at its position."""
    model, w = f32
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, n).astype(np.float32)
               for n in (5, 9, 3, 13, 7)]
    b = ContinuousBatcher(srv, slots=2, capacity=32, **kw)
    rids = [b.submit(p, 6) for p in prompts]
    done = b.run()
    stats = b.stats  # the server's counts, before the solo runs add theirs
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(
            done[rid], srv.generate(p[None], n_new=6)[0].numpy())
        seq = torch.as_tensor(np.concatenate([p, done[rid][:-1]])).long()
        logits = ref.logits(w, seq)[len(p) - 1:]
        gap = logits.max(-1).values - logits.gather(
            1, torch.as_tensor(done[rid])[:, None])[:, 0]
        assert float(gap.max()) <= 1e-4
    assert stats["active"] == 0 and stats["queued"] == 0
    if kw.get("pool_pages") == 5:
        assert stats["preemptions"] > 0
    # 7 Mamba layers are given every prefill position and every slot of
    # a decode step, each counted once: as a token that advanced a state
    # or as padding
    assert stats["scan_tokens"] + stats["scan_padded_tokens"] == 7 * (
        stats["prefill_tokens"] + stats["prefill_padded_tokens"]
        + 2 * stats["decode_steps"])
    if kw["paged"]:
        # a parked row writes the trash page, and its state stays
        assert stats["scan_tokens"] == 7 * (stats["prefill_tokens"]
                                            + stats["decode_tokens"])
    else:
        # a dense cache's parked row advances a state admission resets
        assert stats["scan_padded_tokens"] == \
            7 * stats["prefill_padded_tokens"]


def test_admission_writes_the_slot_state_and_leaves_other_slots(f32):
    """Admission overwrites whatever a slot's state held with the
    prompt's own prefill state (one token asked, so no decode step runs
    after it); the slots it did not take keep theirs."""
    model, _ = f32
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    b = ContinuousBatcher(srv, slots=3, capacity=32, paged=True,
                          page_size=4, pool_pages=24, attention="flash")
    states = [c for c in b.caches if isinstance(c, mamba.MambaState)]
    for st in states:
        for t in st:
            t.fill_(7.0)
    prompt = tokens(1, 6, seed=6)[0]
    b.submit(prompt, 1)
    b.run()
    _, alone = srv.prefill(prompt[None], srv.init_caches(1, 32))
    alone = [c for c in alone if isinstance(c, mamba.MambaState)]
    for st, want in zip(states, alone):
        for t, w in zip(st, want):
            np.testing.assert_allclose(t[0].numpy(), w[0].numpy(), rtol=0,
                                       atol=1e-6)
            assert bool((t[1:] == 7.0).all())


def test_kernel_twins_against_the_sequential_scan():
    """The conv and scan twins, run in two pieces from the state the
    first left (ragged rows, strided x and z views), equal one sequential
    pass over each row's true positions; positions past a row's length
    give 0 and leave its state."""
    g = torch.Generator().manual_seed(7)
    b, t, d, n, k = 3, 10, 32, 16, 4

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g) * s

    xz, dt = r(b, t, 2 * d), r(b, t, d, s=0.5)
    bm, cm = r(b, t, n), r(b, t, n)
    w, bias = r(d, k, s=0.5), r(d, s=0.1)
    a_log = torch.log(torch.arange(1.0, n + 1)).repeat(d, 1)
    dd, dtb = torch.ones(d), r(d, s=0.5) - 3.0
    lens = torch.tensor([10, 6, 0])
    x, z = xz[..., :d], xz[..., d:]
    st = mamba.init_state(b, d, k, n, "cpu")
    cut = 4
    outs = []
    for lo, hi in ((0, cut), (cut, t)):
        part = (lens - lo).clamp(0, hi - lo)
        xc = mamba.causal_conv_plain(x[:, lo:hi], w, bias, st.conv, part)
        outs.append(mamba.selective_scan_plain(
            xc, dt[:, lo:hi], z[:, lo:hi], bm[:, lo:hi], cm[:, lo:hi],
            a_log, dd, dtb, st.ssm, part))
    y = torch.cat(outs, 1)
    for row in range(b):
        m = int(lens[row])
        s = torch.zeros(d, n)
        win = torch.zeros(k - 1, d)
        for i in range(m):
            full = torch.cat([win, x[row, i:i + 1]])
            xi = mamba.silu(bias + (full * w.t()).sum(0))
            win = full[1:]
            delta = torch.nn.functional.softplus(dt[row, i] + dtb)
            s = (torch.exp(delta[:, None] * -torch.exp(a_log)) * s
                 + (delta * xi)[:, None] * bm[row, i][None, :])
            want = ((s * cm[row, i]).sum(-1) + dd * xi) * mamba.silu(
                z[row, i])
            np.testing.assert_allclose(y[row, i].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)
        assert float(y[row, m:].abs().sum()) == 0
        np.testing.assert_allclose(st.ssm[row].numpy(), s.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st.conv[row].numpy(), win.t().numpy(),
                                   rtol=0, atol=0)


def test_mixer_through_the_twins_is_the_references():
    model, w = compiled()
    srv = FlashLMServer(model)
    layer = srv.blocks[0]
    u = torch.as_tensor(np.random.default_rng(8).normal(size=(2, 9, 64)),
                        dtype=torch.float32)
    st = srv.init_state(2)
    got = mamba.mixer(u, layer.mixer, st, torch.tensor([9, 9]), srv.eps)
    want = ref.mamba(CFG, w.layers[0], u)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 5, 40])
def test_routed_experts_equal_dense_masked(rows, monkeypatch):
    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, 64, generator=g)
    router = torch.randn(64, 4, generator=g)
    wg, wu = torch.randn(2, 4, 64, 96, generator=g) * 0.1
    wd = torch.randn(4, 96, 64, generator=g) * 0.1
    seen = []
    swiglu = moe.swiglu

    def counted(xs, *ws):
        seen.append(xs.shape[0])
        return swiglu(xs, *ws)

    monkeypatch.setattr(moe, "swiglu", counted)
    routed = moe.swiglu_routed(x, router, wg, wu, wd, 2)
    # each expert ran once, on exactly the tokens routed to it
    assert sum(seen) == 2 * rows and len(seen) <= 4
    dense = moe.swiglu_dense_masked(x, router, wg, wu, wd, 2)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), rtol=0,
                               atol=1e-6)
    idx, weight = moe.route_top(x, router, 2)
    probs = torch.softmax(x @ router, -1)
    np.testing.assert_allclose(weight.numpy(),
                               probs.gather(1, idx).numpy())  # no renorm


def test_tied_router_picks_the_lower_experts():
    x = torch.ones(3, 8)
    router = torch.zeros(8, 4)
    idx, weight = moe.route_top(x, router, 2)
    assert idx.tolist() == [[0, 1]] * 3
    np.testing.assert_allclose(weight.numpy(), 0.25)


def test_refusals(f32):
    model, _ = f32
    srv = FlashLMServer(model)
    p = tokens(1, 5)
    for call in (lambda: srv.generate_beam(p, 3, beams=2),
                 lambda: srv.generate_speculative(srv, p, 3, k=2),
                 lambda: srv.generate_lookup(p, 3, k=2),
                 lambda: FlashLMServer(model, weight_dtype=torch.int8),
                 lambda: FlashLMServer(model, mesh=object()),
                 lambda: ContinuousBatcher(srv, slots=2, capacity=32,
                                           draft=srv),
                 lambda: ContinuousBatcher(srv, slots=2, capacity=32,
                                           lookup=True),
                 lambda: ContinuousBatcher(srv, slots=2, capacity=32,
                                           paged=True, page_size=4,
                                           prefill_chunk=8),
                 lambda: ContinuousBatcher(srv, slots=2, capacity=32,
                                           paged=True, page_size=4
                                           ).register_prefix(p[0])):
        with pytest.raises(ModelRuntimeError, match="Mamba|recurrent"):
            call()


@pytest.mark.parametrize("which", ["float64-forward", "backward"])
def test_extern_refuses_the_python_scan_off_the_cpu(which):
    """Off the CPU (a meta tensor stands in for the card) the extern runs
    the kernels or raises: a float64 mixer and the backward, which has
    no kernel, are refused rather than scanned in Python there."""
    dtype = torch.float64 if which == "float64-forward" else torch.float32
    di, n, rank, dim = 16, 16, 4, 8
    shapes = [(dim, 2 * di), (di, 4), (di,), (di, rank + 2 * n), (rank,),
              (n,), (n,), (rank, di), (di,), (di, n), (di,), (di, dim)]
    u = torch.zeros((1, 3, dim), dtype=dtype, device="meta")
    weights = [torch.zeros(sh, dtype=dtype, device="meta") for sh in shapes]
    with pytest.raises(ModelRuntimeError, match="CPU"):
        if which == "backward":
            mamba._mamba_grad([u, *weights, torch.zeros_like(u)], {}, None)
        else:
            mamba._mamba([u, *weights], {}, None)


def test_spans_and_counters(f32):
    model, _ = f32
    srv = FlashLMServer(model)
    b = ContinuousBatcher(srv, slots=2, capacity=32, paged=True,
                          page_size=4, pool_pages=20, attention="flash",
                          decode_chunk=2)
    launches = mamba.scan_launches
    tracing.clear()
    with torch.profiler.profile():
        for n in (5, 9, 3):
            b.submit(tokens(1, n, seed=n)[0], 4)
        b.run()
        found = tracing.spans()
    scans = [s for s in found if s["name"] == "egt.server.mamba"]
    moes = [s for s in found if s["name"] == "egt.server.moe"]
    assert {s["attrs"]["phase"] for s in scans} == {"prefill", "decode"}
    assert {s["attrs"]["layer"] for s in scans} == {0, 1, 2, 3, 5, 6, 7}
    assert all(set(s["attrs"]) == {"layer", "phase", "rows", "tokens"}
               for s in scans)
    paths = {(s["attrs"]["phase"], s["attrs"]["path"]) for s in moes}
    assert paths == {("prefill", "routed"), ("decode", "dense-masked")}
    stats = b.stats
    # prefill computes only routed rows; a decode step every expert on
    # every slot
    assert stats["moe_routed_rows"] == 4 * 2 * (stats["prefill_tokens"]
                                                + stats["decode_tokens"])
    assert stats["moe_computed_rows"] == 4 * (
        2 * stats["prefill_tokens"] + 4 * 2 * stats["decode_steps"])
    assert mamba.scan_launches == launches  # kernels only run on a card


def test_dense_model_records_nothing_new():
    model = egt.compile(flash_transformer(vocab=12, dim=16, heads=2,
                                          blocks=1, max_seq=32), seed=0,
                        device="cpu")
    srv = FlashLMServer(model)
    assert srv.mixers == ("attention",) and not srv.recurrent
    b = ContinuousBatcher(srv, slots=2, capacity=32, paged=True,
                          page_size=4, attention="flash", decode_chunk=2)
    tracing.clear()
    with torch.profiler.profile():
        b.submit(tokens(1, 6)[0] % 12, 4)
        b.run()
        names = {s["name"] for s in tracing.spans()}
    assert not any(n.startswith("egt.server.") for n in names)
    assert set(b.stats) == {
        "decode_steps", "dispatches", "active", "queued", "prefill_tokens",
        "prefill_padded_tokens", "decode_tokens", "skinny_launches",
        "skinny_declined", "free_pages", "pool_pages", "preemptions",
        "window_evicted", "prefixes", "prefix_hits"}
