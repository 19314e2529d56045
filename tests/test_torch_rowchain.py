"""Port parity: row chains fused into the generated kernel B6
(exprgrad_torch/backend/rowchain.py, exprgrad_torch/ops/rowchain.py).

The cases of tests/test_pallas_rowchain.py (and the layer_norm chain of
tests/test_pallas_general.py), built once with each package's builder
and run three ways: the port on the CPU (its wrapper runs the plain
version, the members in order, but the plan, the stats and the generated
source are the card's), the JAX package (``backend="jax"``,
``schedule_mode="force"``, Pallas in interpret mode) and
``backend="interp"``.  Outputs and gradients agree at float32
``rtol=1e-5, atol=1e-6`` (softmax and norm rows, summed in other
orders; ``2e-4`` for the gradient, as the JAX test holds it) and the
stats map one to one (``pallas-rowchain`` to ``rowchain``).  Then the
golden Triton source of the softmax and rms_norm chains, seeded fuzz
chains, the Hopper planner's own declines, the wrapper on a device it
does not run on, the classification cache and the ``auto`` rule.
"""

import builtins
import warnings

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers  # noqa: F401
import exprgrad_tpu
import exprgrad_tpu.layers  # noqa: F401
from chip_smoke import (ROWCHAIN_FAMILIES, assert_same, chain_rms,
                        fuzz_case, softmax_chain, transformer_head)
from exprgrad_torch.backend import mapreduce as port_mapreduce
from exprgrad_torch.backend.rowchain import ROW_LIMIT
from exprgrad_torch.ops import rowchain as ops_rowchain
from exprgrad_tpu import compile

F32 = dict(rtol=1e-5, atol=1e-6)
STAT_NAMES = {"pallas": "matmul", "pallas-fused": "matmul-fused",
              "pallas-mapreduce": "mapreduce", "pallas-rowchain": "rowchain"}

pytestmark = pytest.mark.filterwarnings(
    "ignore::exprgrad_tpu.ScheduleWarning",
    "ignore::exprgrad_torch.ScheduleWarning",
)


def _mapped(stats):
    return {STAT_NAMES.get(k, k): v for k, v in stats.items()}


def _models(build, target="out"):
    port_graph, args = build(egt)
    ref_graph, _ = build(exprgrad_tpu)
    port = egt.compile(port_graph, seed=0, schedule_mode="force",
                       device="cpu")
    ref = compile(ref_graph, seed=0, backend="jax", schedule_mode="force")
    interp = compile(ref_graph, seed=0, backend="interp")
    return port, ref, interp, args


def _three_ways(build, tol=F32, target="out"):
    port, ref, interp, args = _models(build, target)
    got = port.call(target, args)
    assert_same(target, got, np.asarray(ref.call(target, args)), tol)
    assert_same(target, got, np.asarray(interp.call(target, args)), tol)
    stats = port.lowering_stats(target)
    assert stats == _mapped(ref.lowering_stats(target))
    return port, stats


def _chains(model):
    return [c for ex in model._executors.values()
            for c in ex.row_fused.values()]


@pytest.mark.parametrize("family", sorted(ROWCHAIN_FAMILIES))
def test_chain_matches_jax(family):
    port, stats = _three_ways(ROWCHAIN_FAMILIES[family])
    assert stats.get("rowchain") == 1, stats
    (chain,) = _chains(port)
    builtins.compile(chain.compiled().source, family, "exec")


def test_chain_shares_input_operand():
    """Members reading the same input block load it once: one operand."""
    port, _ = _three_ways(ROWCHAIN_FAMILIES["shared_operand"])
    (chain,) = _chains(port)
    assert len(chain.compiled().tids) == 1
    (softmax,) = _chains(_three_ways(ROWCHAIN_FAMILIES["softmax"])[0])
    assert len(softmax.compiled().tids) == 1
    assert softmax.compiled().source.count("tl.load(") == 1


def test_escaping_intermediate_is_an_output():
    port, stats = _three_ways(ROWCHAIN_FAMILIES["escaping"])
    (chain,) = _chains(port)
    assert chain.escaping == [0]
    kern = chain.compiled()
    assert len(kern.out_tids) == 2


def _training_softmax(m):
    w = m.param([32, 128], name="w")
    y, x = m.iters("y", "x")
    mx = m.Fun("mx")
    mx.maximize[y] = w[y, x]
    mx.schedule(tile={"y": 16})
    y, x = m.iters("y", "x")
    sums = m.Fun("sums")
    sums[y] = m.exp(w[y, x] - mx[y])
    sums.schedule(tile=None)
    y, x = m.iters("y", "x")
    sm = m.Fun("sm")
    sm[y, x] = m.exp(w[y, x] - mx[y]) / sums[y]
    it = m.iters("it")
    loss = m.Fun("loss")
    loss[0] = m.sq(sm.raw[it])
    return loss.target("loss").backwards().grad(w).target("out"), {}


def test_training_softmax_gradient_matches_jax():
    """The backward target reads the forward max and sums: the forward
    chain still fuses, with them as extra outputs, and the gradient
    matches."""
    port, stats = _three_ways(_training_softmax, dict(rtol=2e-4, atol=2e-5))
    assert stats.get("rowchain", 0) >= 1, stats
    assert any(chain.escaping for chain in _chains(port))


def test_transformer_head_trains_as_jax():
    """chip_smoke.py's path (d) head, narrow: predict and two adam steps
    agree with the JAX package, with the same routes."""
    ref = compile(transformer_head(exprgrad_tpu, 32, 48), backend="jax",
                  seed=0, schedule_mode="force")
    port = egt.from_state(transformer_head(egt, 32, 48), ref.params,
                          ref.caches, ref.epoch,
                          ref._rng.bit_generator.state,
                          schedule_mode="force", device="cpu")
    rng = np.random.default_rng(0)
    args = {"x": rng.normal(size=(64, 32)).astype(np.float32),
            "labels": np.eye(48, dtype=np.float32)[rng.integers(0, 48, 64)]}
    np.testing.assert_allclose(port.call("predict", {"x": args["x"]}),
                               ref.call("predict", {"x": args["x"]}),
                               rtol=1e-5, atol=1e-6)
    for _ in range(2):
        for model in (port, ref):
            model.epoch += 1
            model.apply("train", args)
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(),
                                   np.asarray(value), rtol=1e-4, atol=2e-5)
    for target in ("predict", "train"):
        assert port.lowering_stats(target) == _mapped(
            ref.lowering_stats(target))
    assert port.lowering_stats("predict")["rowchain"] == 2
    assert port.lowering_stats("train")["rowchain"] == 3


def _two_writer(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    ss = m.Fun("ss")
    ss[y] = m.sq(inp[y, x])
    ss.schedule(tile={"y": 16})
    y2 = m.iters("y2")
    ss[y2] = 1e-6
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = inp[y, x] / m.sqrt(ss[y])
    out.schedule(tile={"y": 16})
    return out.target("out"), {"inp": np.random.default_rng(6).normal(
        size=(32, 128)).astype(np.float32)}


def _permuted_ingroup(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    t = m.Fun("t")
    t[y, x] = inp[y, x] * 2.0
    t.schedule(tile={"y": 16})
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = t[x, y] + inp[y, x]
    out.schedule(tile={"y": 16})
    return out.target("out"), {"inp": np.random.default_rng(9).normal(
        size=(64, 64)).astype(np.float32)}


@pytest.mark.parametrize("build", [_two_writer, _permuted_ingroup],
                         ids=["two_writer", "permuted_ingroup_read"])
def test_chain_declines_as_jax(build):
    port, stats = _three_ways(build)
    assert "rowchain" not in stats, stats


def test_static_fold_div_by_zero_runs_ieee():
    """A static division by zero takes the runtime (IEEE) path: inf."""
    def build(m):
        inp = m.input("inp")
        y, x = m.iters("y", "x")
        out = m.Fun("out")
        out[y, x] = inp[y, x] * (
            m.to_scalar(1) / m.to_scalar(inp.shape[1] - inp.shape[1]))
        out.schedule(tile={"y": 16})
        return out.target("out"), {"inp": np.ones((32, 128), np.float32)}

    port, ref, interp, args = _models(build)
    got = port.call("out", args)
    assert np.all(np.isinf(got))
    ref.call("out", args)
    assert port.lowering_stats("out") == _mapped(ref.lowering_stats("out"))
    ex, = port._executors.values()
    (low,) = ex._lowerings.values()
    assert 'float("inf")' in low.scheduled_mapreduce().compiled().source


def test_row_tile_rank1_raises():
    with pytest.raises(egt.ParserError, match="row_tile"):
        egt.layers.softmax(egt.input("inp"), rank=1, row_tile=32)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_chain_route_matches_jax(seed):
    port_graphs, args = fuzz_case(egt, "rowchain", seed)
    ref_graphs, _ = fuzz_case(exprgrad_tpu, "rowchain", seed)
    port = egt.compile(port_graphs, seed=0, schedule_mode="force",
                       device="cpu")
    ref = compile(ref_graphs, seed=0, backend="jax", schedule_mode="force")
    for target in ("out", "esc")[:len(port_graphs)]:
        got = port.call(target, args)
        assert_same(f"{seed} {target}", got,
                    np.asarray(ref.call(target, args)),
                    dict(rtol=3e-4, atol=3e-4))
        assert port.lowering_stats(target) == _mapped(
            ref.lowering_stats(target))


# --- the Hopper planner's own declines ---------------------------------

def _wide_softmax(m):
    return softmax_chain(m, {"y": 1}, rows=2, cols=ROW_LIMIT + 8, scale=1.0)


def _partial_reduction(m):
    a = m.input("a")
    y, x, z = m.iters("y", "x", "z")
    k0 = m.Fun("k0")
    k0[y, z] = a[y, x, z] * 0.5
    k0.schedule(tile={"y": 4})
    y, x, z = m.iters("y", "x", "z")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x, z]) * k0[y, z]
    out.schedule(tile={"y": 4})
    return out.target("out"), {"a": np.random.default_rng(4).normal(
        size=(8, 6, 5)).astype(np.float32)}


@pytest.mark.parametrize("build,why", [
    (_wide_softmax, f"a row of {ROW_LIMIT + 8} elements exceeds the "
                    f"{ROW_LIMIT} a program holds in registers"),
    (_partial_reduction, "a member reduces part of the axes the chain "
                         "keeps whole (the block holds whole rows)"),
], ids=["row_too_wide", "partial_reduction"])
def test_hopper_planner_declines_where_jax_fuses(build, why):
    """Chains the JAX package fuses but a Hopper program cannot hold run
    member by member on B5, with the same numbers (ROADMAP.md C)."""
    port, ref, interp, args = _models(build)
    got = port.call("out", args)
    np.testing.assert_allclose(got, np.asarray(interp.call("out", args)),
                               rtol=1e-5, atol=1e-5)
    ref.call("out", args)
    assert ref.lowering_stats("out").get("pallas-rowchain") == 1
    stats = port.lowering_stats("out")
    assert "rowchain" not in stats and stats["mapreduce"] >= 2, stats
    (ex,) = port._executors.values()
    assert ex.rowchain_declines and all(
        got == why for _, got in ex.rowchain_declines)


def test_user_row_tile_is_permission_not_the_block():
    """At 8192 columns a tile of 32 rows would be 1 MiB of float32: the
    Hopper planner holds whole rows in registers instead, a few to a
    program (about 16K elements, 4-16 warps)."""
    graph, args = softmax_chain(egt, {"y": 32}, rows=8, cols=8192)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (chain,) = _chains(port)
    plan = chain.compiled().plan
    assert (plan["block_p"], plan["block_q"]) == (1, 8192)
    assert chain.num_warps == 16 and plan["grid"] == 8
    graph, args = softmax_chain(egt, {"y": 32}, rows=8192, cols=64)
    plan = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    plan.executable("out", {"inp": [8192, 64]})
    (chain,) = _chains(plan)
    assert chain.block_p * 64 <= 16384 and chain.num_warps == 4
    assert 8192 // chain.block_p >= 128


def test_rows_past_int32_index_in_int64():
    """A chain over more than 2^31 - 1 elements indexes in int64 (planned
    here, never allocated)."""
    graph, _ = softmax_chain(egt, {"y": 32})
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.executable("out", {"inp": [1 << 22, 1024]})
    (chain,) = _chains(port)
    source = chain.compiled().source
    assert ".to(tl.int64)" in source and "q = tl.arange(0, 1024).to(" \
        "tl.int64)" in source
    builtins.compile(source, "int64", "exec")


# --- the generated source, the wrapper, the cache, auto -------------------

SOFTMAX = '''\
@triton.jit
def egt_rowchain(o0_ptr, x0_ptr):
    p = tl.program_id(0) * 1 + tl.arange(0, 1)
    p_ok = p < 128
    p0 = p
    q = tl.arange(0, 256)
    q_ok = q < 256
    q1 = q
    P_ok = p_ok[:, None]
    Q_ok = q_ok[None, :]
    P0 = p0[:, None]
    Q1 = q1[None, :]
    # member 0: the kernel writing 'mx'
    t0 = P0 * 256 + Q1
    t1 = tl.load(x0_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
    t2 = tl.where(Q_ok, t1, (-float("inf")))
    t3 = tl.max(t2, axis=1)[:, None]
    # member 1: the kernel writing 'sums'
    t4 = t1 - t3
    t5 = libdevice.exp(t4)
    t6 = tl.where(Q_ok, t5, 0.0)
    t7 = tl.sum(t6, axis=1)[:, None]
    # member 2: the kernel writing 'out'
    t8 = t1 - t3
    t9 = libdevice.exp(t8)
    t10 = tl.div_rn(t9, t7)
    o = P0 * 256 + Q1
    tl.store(o0_ptr + o, (t10).to(tl.float32), mask=P_ok & Q_ok)
'''

RMS = '''\
@triton.jit
def egt_rowchain(o0_ptr, x0_ptr):
    p = tl.program_id(0) * 1 + tl.arange(0, 1)
    p_ok = p < 64
    p0 = p
    q = tl.arange(0, 128)
    q_ok = q < 128
    q1 = q
    P_ok = p_ok[:, None]
    Q_ok = q_ok[None, :]
    P0 = p0[:, None]
    Q1 = q1[None, :]
    # member 0: the kernel writing 'ss'
    t0 = P0 * 128 + Q1
    t1 = tl.load(x0_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
    t2 = t1 * t1
    t3 = t2 * 0.0078125
    t4 = tl.where(Q_ok, t3, 0.0)
    t5 = tl.sum(t4, axis=1)[:, None]
    # member 1: the kernel writing 'out'
    t6 = t5 + 1e-06
    t7 = tl.sqrt_rn(t6)
    t8 = tl.div_rn(t1, t7)
    o = P0 * 128 + Q1
    tl.store(o0_ptr + o, (t8).to(tl.float32), mask=P_ok & Q_ok)
'''


@pytest.mark.parametrize("build,text", [
    (lambda m: softmax_chain(m, {"y": 32}), SOFTMAX), (chain_rms, RMS)],
    ids=["softmax", "rms_norm"])
def test_generated_source_is_golden(build, text):
    graph, args = build(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (chain,) = _chains(port)
    head, body = chain.compiled().source.split("\n\n\n")
    assert head.startswith("# Generated by exprgrad_torch.ops.rowchain: "
                           "kernel B6, the port of\n# exprgrad_tpu/backend/"
                           "pallasgen.py:2375")
    assert "# Bound: bytes;" in head and "# Design:" in head
    assert body == text


def test_wrapper_raises_off_the_cpu_and_the_card():
    graph, args = softmax_chain(egt, {"y": 32})
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (ex,) = port._executors.values()
    (chain,) = ex.row_fused.values()
    kern = chain.compiled()

    def no_plain(*_):
        raise AssertionError("the plain version ran")

    kern.plain = no_plain
    meta = {tid: torch.empty(ex.shapes[tid], device="meta")
            for tid in [*kern.tids, *kern.out_tids]}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_rowchain.rowchain_impl(kern, meta, 0)
    assert ops_rowchain.launches == 0


def test_chain_is_planned_once_per_executor():
    """Two calls classify each member once and generate the chain's source
    once."""
    graph, args = softmax_chain(egt, {"y": 32})
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    before = port_mapreduce.classifications
    port.call("out", args)
    (chain,) = _chains(port)
    kern = chain.compiled()
    port.call("out", args)
    assert port_mapreduce.classifications - before == 3
    assert _chains(port)[0].compiled() is kern
    assert port.lowering_stats("out") == {"rowchain": 1}


def test_auto_takes_the_chain_ignore_never(monkeypatch):
    """schedule_mode="auto" fuses a chain the planner accepts where the
    cost model (``policy.rowchain`` with the chain's byte counts) says so:
    under the port's H100 calibration the stats follow its decision;
    under the JAX package's calibrated constants both packages decline
    the small softmax chain and run its members one by one, the same
    stats; "ignore" runs the members on the plain paths, silently."""
    from test_torch_policy import _auto_models, _out

    build = _out(lambda m: softmax_chain(m, {"y": 32}))
    graph, args, _ = build(egt)
    auto = egt.compile(graph, seed=0, device="cpu")
    ignore = egt.compile(graph, seed=0, schedule_mode="ignore", device="cpu")
    got = auto.call("out", args)
    with warnings.catch_warnings():
        warnings.simplefilter("error", egt.ScheduleWarning)
        want = ignore.call("out", args)
    np.testing.assert_allclose(got, want, **F32)
    force = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    force.call("out", args)
    (chain,) = _chains(force)
    (ex,) = auto._executors.values()
    decision = ex.policy.rowchain(chain.operand_bytes, chain.out_bytes,
                                  len(chain.members))
    assert auto.lowering_stats("out").get("rowchain", 0) == int(
        decision.use_pallas)
    assert "rowchain" not in ignore.lowering_stats("out")

    port, ref, args, _ = _auto_models(build, "jax_calibration", monkeypatch)
    got = port.call("out", args)
    np.testing.assert_allclose(got, np.asarray(ref.call("out", args)), **F32)
    stats = port.lowering_stats("out")
    assert stats == _mapped(ref.lowering_stats("out"))
    assert "rowchain" not in stats and stats["schedule-fallback"] == 3
