"""Port parity: scheduled map/reduce kernels through the generated kernel
B5 (exprgrad_torch/backend/mapreduce.py, exprgrad_torch/ops/mapreduce.py).

* One program per family of the JAX package's ``PallasMapReduce``
  (chip_smoke.py's ``MAPREDUCE_FAMILIES``), built once with each
  package's builder and run three ways: the port on the CPU (the wrapper
  runs the plain version, but routing, planning, stats and the generated
  source are the card's), the JAX package (``backend="jax"``,
  ``schedule_mode="force"``, Pallas in interpret mode) and
  ``backend="interp"``.  Outputs agree at float32 ``rtol=1e-5,
  atol=1e-6`` (the same reads and ops, summed in other orders), the
  stats map one to one (``pallas-mapreduce`` to ``mapreduce``) and every
  kernel gets the same verdict and ``why`` from both classifiers.
* Gradients through scheduled forwards, whose derived kernels inherit the
  schedules and run B5 themselves (``rtol=1e-5, atol=1e-5``: the
  backward sums more terms).
* The declines that come from the program (float64, contractions,
  non-static setup, tiles on a shifted axis, grouped and computed dims in
  one read), seeded fuzz cases of the JAX package's fuzzers, the golden
  Triton source of four kernels, the classification cache, the wrapper
  on a device it does not run on, bfloat16, and the ``auto`` rule.
"""

import builtins
import warnings

import jax
import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers  # noqa: F401
import exprgrad_tpu
import exprgrad_tpu.layers  # noqa: F401
from chip_smoke import (MAPREDUCE_FAMILIES, assert_same, fam_elementwise,
                        fam_gather, fam_scatter_add, fam_stencil,
                        fam_triangular, fuzz_case)
from exprgrad_torch.backend import mapreduce as port_mapreduce
from exprgrad_torch.backend.executor import TorchExecutor
from exprgrad_torch.backend.mapreduce import ScheduledMapReduce
from exprgrad_torch.backend.torcheval import KernelLowering
from exprgrad_torch.ops import mapreduce as ops_mapreduce
from exprgrad_torch.passes import infer_shapes
from exprgrad_tpu import compile
from exprgrad_tpu.backend.jaxeval import KernelLowering as JaxLowering
from exprgrad_tpu.backend.pallasgen import PallasMapReduce

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-10, atol=1e-12)
STAT_NAMES = {"pallas": "matmul", "pallas-fused": "matmul-fused",
              "pallas-mapreduce": "mapreduce", "pallas-rowchain": "rowchain"}

pytestmark = pytest.mark.filterwarnings(
    "ignore::exprgrad_tpu.ScheduleWarning",
    "ignore::exprgrad_torch.ScheduleWarning",
)


def _mapped(stats):
    return {STAT_NAMES.get(k, k): v for k, v in stats.items()}


def _models(build, dtype="float32", epoch=3, target="out"):
    """(port, JAX, interp models, inputs) of a builder of chip_smoke.py,
    compiled with schedule_mode="force" from each package's own build,
    at ``epoch``."""
    port_graph, args = build(egt)
    ref_graph, _ = build(exprgrad_tpu)
    if dtype == "float64":
        args = {k: v.astype(np.float64) for k, v in args.items()}
    port = egt.compile(port_graph, dtype=dtype, seed=0,
                       schedule_mode="force", device="cpu")
    ref = compile(ref_graph, dtype=dtype, seed=0, backend="jax",
                  schedule_mode="force")
    interp = compile(ref_graph, dtype=dtype, seed=0, backend="interp")
    for model in (port, ref, interp):
        model.epoch = epoch
    return port, ref, interp, args


def _sources(model):
    """The generated B5 sources of a model's executors."""
    out = []
    for ex in model._executors.values():
        for low in ex._lowerings.values():
            if low._mapreduce is not None and low._mapreduce.ok:
                out.append(low._mapreduce.compiled().source)
    return out


def _verdicts(port, ref, target="out"):
    """(port (ok, why), JAX (ok, why)) of every kernel of ``target``."""
    (shapes,) = [dict(key[1]) for key in port._executors if key[0] == target]
    shapes = {t: list(s) for t, s in shapes.items()}
    out = []
    for kernel, jkernel in zip(port.program.targets[target].kernels,
                               ref.program.targets[target].kernels):
        if kernel.write is None or kernel.extern is not None:
            continue
        low = KernelLowering(port.program, kernel, shapes, port.dtype,
                             torch.device("cpu"))
        jlow = JaxLowering(ref.program, jkernel, shapes,
                           np.dtype(port.program.scalar_type.value).type,
                           jax.lax.Precision.HIGHEST)
        if not low._bounds_ok:
            continue
        mr, pmr = ScheduledMapReduce(low, kernel), PallasMapReduce(
            jlow, jkernel)
        out.append(((mr.ok, mr.why), (pmr.ok, pmr.why)))
    return out


# --- the families ---------------------------------------------------------

@pytest.mark.parametrize("family", sorted(MAPREDUCE_FAMILIES))
def test_family_matches_jax(family):
    port, ref, interp, args = _models(MAPREDUCE_FAMILIES[family])
    got = port.call("out", args)
    assert_same(family, got, np.asarray(ref.call("out", args)), F32)
    assert_same(family, got, np.asarray(interp.call("out", args)), F32)
    assert port.lowering_stats("out") == {"mapreduce": 1}
    assert _mapped(ref.lowering_stats("out")) == {"mapreduce": 1}
    for ours, theirs in _verdicts(port, ref):
        assert ours == theirs
    (source,) = _sources(port)
    builtins.compile(source, family, "exec")


def _embedding_grad(m):
    i, d = m.iters("i", "d")
    tok = m.input("tokens")
    table = m.param([6, 32], name="emb")
    out = m.Fun("out")
    out[i, d] = table[m.to_index(tok[i]), d]
    out.with_shape([tok.shape[0], 32])
    out.schedule(tile={"i": 3})
    it = m.iters("it")
    loss = m.Fun("loss")
    loss[0] = m.sq(out.raw[it])
    toks = np.random.default_rng(7).integers(0, 6, 9).astype(np.float32)
    return (loss.target("loss").backwards().grad(table).target("out"),
            {"tokens": toks})


def _param_grad(m, forward, shape):
    """d sum(forward(w)^2) / dw of a scheduled forward on a parameter."""
    w = m.param(shape, name="w")
    out = forward(m, w)
    it = m.iters("it")
    loss = m.Fun("loss")
    loss[0] = m.sq(out.raw[it])
    return loss.target("loss").backwards().grad(w).target("out"), {}


def _triangular(m, w):
    y = m.iters("y")
    x = m.irange("x", 0, y + 1)
    out = m.Fun("tri")
    out[y] = w[y, x] * 0.5
    out.schedule(tile={"y": 8})
    return out


def _stencil(m, w):
    y = m.iters("y")
    x = m.irange("x", 0, w.shape[1] - 2)
    out = m.Fun("blur")
    out[y, x] = (w[y, x] + w[y, x + 1] + w[y, x + 2]) * (1.0 / 3.0)
    out.schedule(tile={"y": 8})
    return out


def _max_pool(m, w, tile=8):
    y, x = m.iters("y", "x")
    out = m.Fun("pool")
    out[y, x] = m.maximum(w[y * 2, x], w[y * 2 + 1, x])
    out.schedule(tile={"y": tile})
    return out


GRADS = {
    "embedding_scatter": _embedding_grad,
    "triangular": lambda m: _param_grad(m, _triangular, [16, 16]),
    "stencil": lambda m: _param_grad(m, _stencil, [16, 34]),
    "max_pool": lambda m: _param_grad(m, _max_pool, [16, 32]),
}

# decline reasons of the JAX package's planner that come from the TPU (the
# Mosaic alignment of ragged tiles, one gridded reduction axis, the VMEM
# budget): the Hopper planner takes those kernels (ROADMAP.md C)
TPU_ONLY = ("does not divide extent", "more than one tiled reduction axis",
            "blocks exceed the VMEM budget")


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradients_match_jax(name):
    port, ref, interp, args = _models(GRADS[name])
    for tid, value in ref.params.items():
        np.testing.assert_array_equal(port.params[tid].numpy(),
                                      np.asarray(value))
    got = port.call("out", args)
    grad = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref.call("out", args)), **grad)
    np.testing.assert_allclose(got, np.asarray(interp.call("out", args)),
                               **grad)
    stats = port.lowering_stats("out")
    assert stats == _mapped(ref.lowering_stats("out"))
    assert stats.get("mapreduce", 0) >= 1, stats


# --- declines ------------------------------------------------------------

def _contraction(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = a[y, x] * b[y, x]
    out.schedule(tile={"y": 16})
    rng = np.random.default_rng(7)
    return out.target("out"), {"a": rng.normal(size=(32, 64)).astype(
        np.float32), "b": rng.normal(size=(32, 64)).astype(np.float32)}


def _shifted_tile(m):
    img = m.input("img")
    y = m.irange("y", 0, img.shape[0] - 1)
    x = m.iters("x")
    out = m.Fun("out")
    out[y, x] = img[y, x] + img[y + 1, x]
    out.schedule(tile={"y": 8, "x": 128})
    return out.target("out"), {"img": np.random.default_rng(34).normal(
        size=(32, 128)).astype(np.float32)}


def _shifted_read(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = inp[y + 1, x]
    out.with_shape([inp.shape[0] - 1, inp.shape[1]])
    out.schedule(tile={"y": 8})
    return out.target("out"), {"inp": np.random.default_rng(15).normal(
        size=(17, 128)).astype(np.float32)}


def _nonaffine_bound(m):
    a = m.input("a")
    y = m.iters("y")
    x = m.irange("x", 0, (y * y) % 7 + 1)
    out = m.Fun("out")
    out[y] = a[y, x]
    out.with_shape([a.shape[0]])
    out.schedule(tile={"y": 8})
    return out.target("out"), {"a": np.random.default_rng(1).normal(
        size=(16, 7)).astype(np.float32)}


DECLINES = {
    "contraction": (_contraction, "contraction (MXU einsum path)"),
    "shifted_tile": (_shifted_tile, "loop 0 carries a shifted-slice read "
                                    "and cannot tile (overlapping windows)"),
    "shifted_read": (_shifted_read, "loop 0 carries a shifted-slice read "
                                    "and cannot tile (overlapping windows)"),
    "nonaffine_bound": (_nonaffine_bound, "dynamic loop bound is not "
                                          "affine in the iterators"),
}


@pytest.mark.parametrize("name", sorted(DECLINES))
def test_program_declines_as_jax(name):
    build, why = DECLINES[name]
    port, ref, interp, args = _models(build)
    with pytest.warns(egt.ScheduleWarning, match="unsupported kernel shape"):
        got = port.call("out", args)
    np.testing.assert_allclose(got, np.asarray(interp.call("out", args)),
                               **F32)
    np.testing.assert_allclose(got, np.asarray(ref.call("out", args)), **F32)
    stats = port.lowering_stats("out")
    assert stats == _mapped(ref.lowering_stats("out"))
    assert stats["schedule-fallback"] == 1 and "mapreduce" not in stats
    assert [v[0] for v in _verdicts(port, ref)] == [(False, why)]
    assert _verdicts(port, ref)[0][1] == (False, why)


def test_float64_declines_as_jax():
    port, ref, interp, args = _models(fam_elementwise, dtype="float64")
    with pytest.warns(egt.ScheduleWarning, match="float64"):
        got = port.call("out", args)
    np.testing.assert_allclose(got, np.asarray(ref.call("out", args)), **F64)
    np.testing.assert_allclose(got, np.asarray(interp.call("out", args)),
                               **F64)
    assert port.lowering_stats("out") == _mapped(ref.lowering_stats("out"))
    assert _verdicts(port, ref) == [((False, "float64 (VPU computes in "
                                      "f32)"),) * 2]


def test_non_static_setup_declines_as_jax():
    """A kernel-level setup instruction that is not static (arithmetic on
    the epoch; the DSL's own builders keep such values in the expression)
    declines in both classifiers."""
    port, ref, _, args = _models(fam_elementwise)
    port.call("out", args)
    ref.call("out", args)
    verdicts = []
    for model, ir in ((port, egt.ir), (ref, exprgrad_tpu.ir)):
        (kernel,) = model.program.targets["out"].kernels
        a, b = kernel.alloc_reg("e"), kernel.alloc_reg("e2")
        kernel.setup = [ir.Instr(op=ir.Op.EPOCH, res=a),
                        ir.Instr(op=ir.Op.ADD, args=[a, a], res=b)]
    for ours, theirs in _verdicts(port, ref):
        verdicts.append(ours)
        assert ours == theirs
    assert verdicts == [(False, "kernel-level setup instructions are not "
                         "static")]


# --- seeded fuzz cases ---------------------------------------------------

@pytest.mark.parametrize("kind,seed", [("general", s) for s in range(4)]
                         + [("cmpred", s) for s in range(4)])
def test_fuzz_route_matches_jax(kind, seed):
    port_graphs, args = fuzz_case(egt, kind, seed)
    ref_graphs, _ = fuzz_case(exprgrad_tpu, kind, seed)
    port = egt.compile(port_graphs, seed=0, schedule_mode="force",
                       device="cpu")
    ref = compile(ref_graphs, seed=0, backend="jax", schedule_mode="force")
    got = port.call("out", args)
    assert_same(f"{kind} {seed}", got, np.asarray(ref.call("out", args)),
                dict(rtol=3e-4, atol=3e-4))
    (verdict,) = _verdicts(port, ref)
    ours, theirs = verdict
    if any(reason in theirs[1] for reason in TPU_ONLY):
        assert ours == (True, "")
        assert port.lowering_stats("out") == {"mapreduce": 1}
    else:
        assert ours == theirs
        assert port.lowering_stats("out") == _mapped(
            ref.lowering_stats("out"))


@pytest.mark.parametrize("case", ["max_pool_grad", "cmpred_1"])
def test_port_takes_kernels_the_tpu_planner_declines(case):
    """Where the JAX package declines for a TPU limit (a tile that is not a
    multiple of the sublane alignment on a strided read axis; two tiled
    reduction axes), the port runs B5, with the same numbers."""
    if case == "max_pool_grad":
        def build(m):
            return _param_grad(m, lambda m, w: _max_pool(m, w, 4), [16, 32])
        port, ref, interp, args = _models(build)
        want = np.asarray(interp.call("out", args))
    else:
        port_graphs, args = fuzz_case(egt, "cmpred", 1)
        ref_graphs, _ = fuzz_case(exprgrad_tpu, "cmpred", 1)
        port = egt.compile(port_graphs, seed=0, schedule_mode="force",
                           device="cpu")
        ref = compile(ref_graphs, seed=0, backend="jax",
                      schedule_mode="force")
        want = np.asarray(ref.call("out", args))
    got = port.call("out", args)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    ref.call("out", args)
    declined = [theirs for ours, theirs in _verdicts(port, ref)
                if ours[0] and not theirs[0]]
    assert declined and all(any(r in why for r in TPU_ONLY)
                            for _, why in declined)
    stats, theirs = port.lowering_stats("out"), ref.lowering_stats("out")
    assert stats["mapreduce"] == len(declined) + theirs.get(
        "pallas-mapreduce", 0)


# --- the generated source -------------------------------------------------

STENCIL = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(out_ptr, x0_ptr, epoch):
    p = tl.program_id(0) * 1024 + tl.arange(0, 1024)
    p_ok = p < 8192
    p1 = p % 128
    p0 = p // 128
    t0 = (p1 >= 0) & (p1 < 130)
    t1 = p0 * 130 + p1
    t2 = tl.load(x0_ptr + t1, mask=t0 & p_ok, other=0.0).to(tl.float32)
    t3 = p1 + 1
    t4 = (t3 >= 0) & (t3 < 130)
    t5 = p0 * 130 + t3
    t6 = tl.load(x0_ptr + t5, mask=t4 & p_ok, other=0.0).to(tl.float32)
    t7 = t2 + t6
    t8 = p1 + 2
    t9 = (t8 >= 0) & (t8 < 130)
    t10 = p0 * 130 + t8
    t11 = tl.load(x0_ptr + t10, mask=t9 & p_ok, other=0.0).to(tl.float32)
    t12 = t7 + t11
    t13 = t12 * 0.3333333333333333
    acc = t13
    o = p0 * 128 + p1
    tl.store(out_ptr + o, acc.to(tl.float32), mask=p_ok)
'''

TRIANGULAR = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(out_ptr, x0_ptr, epoch):
    p = tl.program_id(0) * 64 + tl.arange(0, 64)
    p_ok = p < 64
    p0 = p
    acc = tl.full([64], (-float("inf")), tl.float32)
    P_ok = p_ok[:, None]
    P0 = p0[:, None]
    for q_start in range(0, 64, 64):
        q = q_start + tl.arange(0, 64)
        q_ok = q < 64
        q1 = q
        Q_ok = q_ok[None, :]
        Q1 = q1[None, :]
        t0 = P0 * 64 + Q1
        t1 = tl.load(x0_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
        t2 = (Q1 >= (0)) & (Q1 < (1 + P0 * 1))
        v = tl.where(P_ok & Q_ok & t2, t1, (-float("inf")))
        acc = tl.maximum(acc, tl.max(v, axis=1))
    o = p0
    tl.store(out_ptr + o, acc.to(tl.float32), mask=p_ok)
'''

GATHER = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(out_ptr, x0_ptr, x1_ptr, epoch):
    p = tl.program_id(0) * 256 + tl.arange(0, 256)
    p_ok = p < 192
    p2 = p % 64
    p0 = p // 64
    acc = tl.full([256], 0.0, tl.float32)
    P_ok = p_ok[:, None]
    P0 = p0[:, None]
    P2 = p2[:, None]
    for q_start in range(0, 5, 8):
        q = q_start + tl.arange(0, 8)
        q_ok = q < 5
        q1 = q
        Q_ok = q_ok[None, :]
        Q1 = q1[None, :]
        t0 = P0 * 5 + Q1
        t1 = tl.load(x0_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
        t2 = t1.to(tl.int32)
        t3 = (t2 >= 0) & (t2 < 8)
        t4 = t2 * 64 + P2
        t5 = tl.load(x1_ptr + t4, mask=t3 & P_ok & Q_ok, other=0.0).to(tl.float32)
        t6 = t5 * 2.0
        t7 = t6 + 1.0
        v = tl.where(P_ok & Q_ok, t7, 0.0)
        acc = acc + tl.sum(v, axis=1)
    o = p0 * 64 + p2
    tl.store(out_ptr + o, acc.to(tl.float32), mask=p_ok)
'''

SCATTER = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_scatter_keys(key_ptr, x0_ptr, x1_ptr, epoch):
    p = tl.program_id(0) * 64 + tl.arange(0, 64)
    p_ok = p < 48
    p0 = p
    t0 = tl.load(x0_ptr + p0, mask=p_ok, other=0.0).to(tl.float32)
    t1 = t0.to(tl.int32)
    key = (tl.zeros([64], tl.int32) + tl.where((t1 >= 0) & (t1 < 11), t1, 11)).to(tl.int16)
    tl.store(key_ptr + p, key, mask=p_ok)

@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(out_ptr, part_ptr, cnt_ptr, skey_ptr, perm_ptr, seg_ptr, x0_ptr, x1_ptr, epoch):
    c = tl.program_id(1) * 32 + tl.arange(0, 32)
    c_ok = c < 24
    q1 = c
    Q_ok = c_ok[None, :]
    Q1 = q1[None, :]
    pid = tl.program_id(0)
    owner = pid < 11
    lo_c = (pid - 11) * 128
    live = (pid >= 11) & (lo_c < tl.load(seg_ptr + 11))
    row = tl.where(owner, pid, tl.load(skey_ptr + lo_c, mask=live, other=11))
    start = tl.load(seg_ptr + row)
    stop = tl.load(seg_ptr + row + 1, mask=row < 11, other=0)
    live = owner | (live & (start < lo_c))
    lo = tl.where(owner, start, lo_c)
    hi = tl.where(owner, tl.minimum(stop, (start // 128 + 1) * 128), tl.where(live, tl.minimum(stop, lo_c + 128), lo_c))
    acc = tl.full([8, 32], 0.0, tl.float32)
    for s0 in range(lo, hi, 8):
        s = s0 + tl.arange(0, 8)
        s_ok = s < hi
        p = tl.load(perm_ptr + s, mask=s_ok, other=0).to(tl.int32)
        p0 = p
        P_ok = s_ok[:, None]
        P0 = p0[:, None]
        t0 = P0 * 24 + Q1
        t1 = tl.load(x1_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
        v = tl.where(P_ok & Q_ok, t1, 0.0)
        acc = acc + v
    acc = tl.sum(acc, axis=0)
    c0 = start // 128
    c1 = (stop - 1) // 128
    multi = (stop > start) & (c1 > c0)
    if owner & ~multi:
        o = (row) * 24 + q1
        tl.store(out_ptr + o, acc.to(tl.float32), mask=c_ok)
    if live & multi:
        at = tl.where(owner, c0, pid - 11 + 1)
        tl.store(part_ptr + at * 24 + c, acc, mask=c_ok)
        tl.debug_barrier()
        n = tl.atomic_add(cnt_ptr + c0 * 1 + tl.program_id(1), 1)
        if n == c1 - c0:
            acc = tl.load(part_ptr + c0 * 24 + c, mask=c_ok, cache_modifier=".cg")
            for e in range(c0 + 1, c1 + 1):
                carried = tl.load(part_ptr + (e + 1) * 24 + c, mask=c_ok, cache_modifier=".cg")
                acc = acc + carried
            o = (row) * 24 + q1
            tl.store(out_ptr + o, acc.to(tl.float32), mask=c_ok)
            tl.store(cnt_ptr + c0 * 1 + tl.program_id(1), 0)
'''

GOLDEN = {"stencil": (fam_stencil, STENCIL),
          "triangular": (fam_triangular, TRIANGULAR),
          "gather": (fam_gather, GATHER),
          "scatter": (fam_scatter_add, SCATTER)}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_generated_source_is_golden(name):
    build, text = GOLDEN[name]
    graph, args = build(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (source,) = _sources(port)
    head, body = source.split("\n\n\n")
    assert head.startswith("# Generated by exprgrad_torch.ops.mapreduce: "
                           "kernel B5, the port of\n# exprgrad_tpu/backend/"
                           "pallasgen.py:1804")
    assert "# Bound: bytes;" in head and "# Design:" in head
    assert body == text


def _kernel_of(build):
    graph, args = build(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (ex,) = port._executors.values()
    (low,) = [low for low in ex._lowerings.values()
              if low._mapreduce is not None and low._mapreduce.ok]
    return low.scheduled_mapreduce()


@pytest.mark.parametrize("family", ["gridded_reduction", "constant_write",
                                    "ragged"])
def test_reductions_loop_inside_one_program(family):
    """A reduction the TPU grids, and the scalar all-reduce, run as a
    loop inside the program that owns the output: no atomics, one order,
    the same bits on every run."""
    mr = _kernel_of(MAPREDUCE_FAMILIES[family])
    source = mr.compiled().source
    assert "for q_start in range(0, " in source
    assert "tl.atomic" not in source
    assert mr.q_axes and not mr.scatter


@pytest.mark.parametrize("family,reduce", [
    ("scatter_add", "tl.sum"), ("scatter_max", "tl.max"),
    ("scatter_min", "tl.min"), ("pure_scatter", "tl.sum")])
def test_scatters_are_masked_float32_atomics(family, reduce):
    """A scatter owns its output (the name is the atomic design's, which
    this replaced): no float atomic in its source, only the int32 count
    of a long segment's finished pieces (its grouping is a stable sort of
    integer keys); the keys kernel drops a target outside the tensor (key
    K); the reduction walks a segment with the mode's reduce and stores
    each owned element once: its owner, or the last of its pieces."""
    mr = _kernel_of(MAPREDUCE_FAMILIES[family])
    kern = mr.compiled()
    source = kern.source
    atomics = [ln.strip() for ln in source.splitlines() if "tl.atomic" in ln]
    assert len(atomics) == 1
    assert atomics[0].startswith("n = tl.atomic_add(cnt_ptr + c0 * ")
    keys, body = source.split("def egt_mapreduce(")
    (key,) = [ln.strip() for ln in keys.splitlines()
              if ln.strip().startswith("key = ")]
    sc = mr.scatter
    assert f"< {sc['V']})" in key and ">= 0)" in key
    assert key.endswith(f", {sc['K']})).to(tl.int16)")
    assert f"{reduce}(acc, axis=0)" in body
    stores = [ln.strip() for ln in body.splitlines()
              if "tl.store(out_ptr" in ln]
    assert len(stores) == 2 and stores[0] == stores[1]
    assert "    if owner & ~multi:" in body and "if n == c1 - c0:" in body
    chunks = kern.plan["chunks"]  # a program a row, one a later chunk
    assert kern.plan["grid"][0] == sc["K"] + (chunks if chunks > 1 else 0)


def test_positions_past_int32_index_in_int64():
    """A tensor of more than 2^31 - 1 elements moves the kernel's
    positions and addresses to int64 (planned here, never allocated)."""
    graph, _ = fam_elementwise(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.executable("out", {"inp": [65536, 40000]})
    (ex,) = port._executors.values()
    (low,) = [ex._lowering(i) for i in range(len(ex.target.kernels))]
    source = low.scheduled_mapreduce().compiled().source
    assert "p = tl.program_id(0).to(tl.int64) * 1024" in source
    assert "tl.arange(0, 1024).to(tl.int64)" in source
    builtins.compile(source, "int64", "exec")


def test_computed_addresses_are_masked():
    """A gathered index outside [0, V) loads nothing (it reads 0, as the
    TPU kernel's compare-select does); the plain version clamps, as the
    JAX package's XLA path does.  Inside the range both agree."""
    source = _kernel_of(fam_gather).compiled().source
    assert "t3 = (t2 >= 0) & (t2 < 8)" in source
    assert "mask=t3 & P_ok & Q_ok" in source


# --- the executor's cache, the wrapper, bfloat16, auto --------------------

def test_classification_runs_once_per_kernel():
    """Two calls classify each kernel and generate its source once: the
    executor keeps the lowering, the verdict and the kernel."""
    graph, args = fam_gather(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    before = port_mapreduce.classifications
    port.call("out", args)
    first = port_mapreduce.classifications - before
    sources = _sources(port)
    port.call("out", args)
    assert first == 1
    assert port_mapreduce.classifications - before == 1
    assert [s is t for s, t in zip(sources, _sources(port))] == [True]


def test_wrapper_raises_off_the_cpu_and_the_card():
    """A tensor on another device reaches neither the plain version nor a
    launch: the wrapper raises."""
    graph, args = fam_scatter_add(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (ex,) = port._executors.values()
    (low,) = ex._lowerings.values()
    kern = low.scheduled_mapreduce().compiled()

    def no_plain(*_):
        raise AssertionError("the plain version ran")

    kern.plain = no_plain
    meta = {tid: torch.empty(ex.shapes[tid], device="meta")
            for tid in [*kern.tids, kern.out_tid]}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_mapreduce.mapreduce_impl(kern, meta, 0)
    assert ops_mapreduce.launches == 0


def test_bfloat16_routes_as_float32():
    """A bfloat16 program takes the same route; its kernel loads bfloat16,
    computes in float32 and stores bfloat16 once (here the plain version
    runs, in bfloat16: within 2^-7 of the float32 model)."""
    graph, args = fam_gather(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    want = port.call("out", args)
    prog = port.program.copy()
    prog.scalar_type = egt.ir.ScalarType.BF16
    shapes = infer_shapes(prog, "out", [(prog.inputs[n], list(v.shape))
                                        for n, v in args.items()])
    ex = TorchExecutor(prog, "out", shapes, torch.device("cpu"), "force")
    got = ex.run({prog.inputs[n]: torch.from_numpy(v).bfloat16()
                  for n, v in args.items()}, shapes, 0, 0)
    out = got[prog.targets["out"].output]
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    assert ex.stats == {"mapreduce": 1}
    (low,) = ex._lowerings.values()
    source = low.scheduled_mapreduce().compiled().source
    assert ".to(tl.bfloat16)" in source


def test_auto_takes_the_kernel_where_jax_falls_back(monkeypatch):
    """schedule_mode="auto" asks the cost model (``policy.mapreduce`` with
    the classifier's byte counts): under the JAX package's calibrated
    constants both packages send a small scheduled map to the plain
    lowering with a ScheduleWarning and the same stats; under the port's
    H100 calibration the stats follow the port's own decision; "ignore"
    never runs B5."""
    from test_torch_policy import _auto_models, _out

    port_graph, args = fam_elementwise(egt)
    port = egt.compile(port_graph, seed=0, device="cpu")
    got = port.call("out", args)
    (ex,) = port._executors.values()
    (low,) = ex._lowerings.values()
    mr = low.scheduled_mapreduce()
    decision = ex.policy.mapreduce(mr.total_bytes, mr.gather_work * 4)
    stats = port.lowering_stats("out")
    assert stats.get("mapreduce", 0) == int(decision.use_pallas)
    assert stats.get("schedule-fallback", 0) == int(not decision.use_pallas)

    port, ref, args, _ = _auto_models(_out(fam_elementwise),
                                      "jax_calibration", monkeypatch)
    with pytest.warns(egt.ScheduleWarning, match="cost model"):
        got = port.call("out", args)
    np.testing.assert_allclose(got, np.asarray(ref.call("out", args)), **F32)
    assert port.lowering_stats("out") == _mapped(ref.lowering_stats("out"))
    assert ref.lowering_stats("out")["schedule-fallback"] == 1
    ignore = egt.compile(port_graph, seed=0, schedule_mode="ignore",
                         device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", egt.ScheduleWarning)
        ignore.call("out", args)
    assert "mapreduce" not in ignore.lowering_stats("out")
