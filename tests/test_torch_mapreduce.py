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
from chip_smoke import (MAPREDUCE_FAMILIES, assert_same,
                        fam_column_reduction, fam_elementwise, fam_gather,
                        fam_scatter_add, fam_stencil, fam_triangular,
                        fuzz_case)
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
    p = tl.program_id(0) * 256 + tl.arange(0, 256)
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
    o = p
    tl.store(out_ptr + o, acc.to(tl.float32), mask=p_ok)
'''

TRIANGULAR = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(out_ptr, x0_ptr, epoch):
    p = tl.program_id(0) * 64 + tl.arange(0, 64)
    p_ok = p < 64
    p0 = p
    P_ok = p_ok[:, None]
    P0 = p0[:, None]
    acc2 = tl.full([64, 64], (-float("inf")), tl.float32)
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
        acc2 = tl.maximum(acc2, v)
    acc = tl.max(acc2, axis=1)
    o = p0
    tl.store(out_ptr + o, acc.to(tl.float32), mask=p_ok)
'''

GATHER = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(out_ptr, x0_ptr, x1_ptr, epoch):
    p = tl.program_id(0) * 128 + tl.arange(0, 128)
    p_ok = p < 192
    p2 = p % 64
    p0 = p // 64
    P_ok = p_ok[None, :]
    P0 = p0[None, :]
    P2 = p2[None, :]
    acc2 = tl.full([8, 128], 0.0, tl.float32)
    for q_start in range(0, 5, 8):
        q = q_start + tl.arange(0, 8)
        q_ok = q < 5
        q1 = q
        Q_ok = q_ok[:, None]
        Q1 = q1[:, None]
        t0 = P0 * 5 + Q1
        t1 = tl.load(x0_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
        t2 = t1.to(tl.int32)
        t3 = (t2 >= 0) & (t2 < 8)
        t4 = t2 * 64 + P2
        t5 = tl.load(x1_ptr + t4, mask=t3 & P_ok & Q_ok, other=0.0).to(tl.float32)
        t6 = t5 * 2.0
        t7 = t6 + 1.0
        v = tl.where(P_ok & Q_ok, t7, 0.0)
        acc2 = acc2 + v
    acc = tl.sum(acc2, axis=0)
    o = p0 * 64 + p2
    tl.store(out_ptr + o, acc.to(tl.float32), mask=p_ok)
'''

COLUMN = '''\
@triton.jit(do_not_specialize=["epoch"])
def egt_mapreduce(part_ptr, x0_ptr, x1_ptr, epoch):
    p = tl.program_id(0) * 64 + tl.arange(0, 64)
    p_ok = p < 64
    p1 = p
    P_ok = p_ok[None, :]
    P1 = p1[None, :]
    acc2 = tl.full([64, 64], 0.0, tl.float32)
    q_lo = tl.program_id(1) * 64
    for q_start in range(0, 64, 64):
        q = q_lo + q_start + tl.arange(0, 64)
        q_ok = q < 1024
        q0 = q
        Q_ok = q_ok[:, None]
        Q0 = q0[:, None]
        t0 = Q0 * 64 + P1
        t1 = tl.load(x0_ptr + t0, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
        t2 = Q0 * 64 + P1
        t3 = tl.load(x1_ptr + t2, mask=P_ok & Q_ok, other=0.0).to(tl.float32)
        t4 = t1 - t3
        t5 = t4 * t4
        v = tl.where(P_ok & Q_ok, t5, 0.0)
        acc2 = acc2 + v
    acc = tl.sum(acc2, axis=0)
    tl.store(part_ptr + tl.program_id(1) * 64 + p, acc, mask=p_ok)

@triton.jit
def egt_mapreduce_combine(out_ptr, part_ptr):
    p = tl.program_id(0) * 64 + tl.arange(0, 64)
    p_ok = p < 64
    p1 = p
    acc2 = tl.full([16, 64], 0.0, tl.float32)
    for s0 in range(0, 16, 16):
        s = s0 + tl.arange(0, 16)
        part = tl.load(part_ptr + s[:, None] * 64 + p[None, :], mask=(s[:, None] < 16) & p_ok[None, :], other=0.0)
        acc2 = acc2 + part
    acc = tl.sum(acc2, axis=0)
    o = p
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
          "column reduction": (fam_column_reduction, COLUMN),
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
    loop inside the program that owns the output or, where the reduction
    is split (the all-reduce's 8192 positions), inside the program that
    owns a chunk of it, whose float32 partial one combine kernel adds to
    the others in a fixed order: no atomics, one order, the same bits on
    every run."""
    mr = _kernel_of(MAPREDUCE_FAMILIES[family])
    kern = mr.compiled()
    source = kern.source
    assert "for q_start in range(0, " in source
    assert "tl.atomic" not in source
    assert mr.q_axes and not mr.scatter
    split = kern.plan["splits"] > 1
    assert split == (family == "constant_write")
    assert ("def egt_mapreduce_combine(out_ptr, part_ptr):" in source) \
        == split


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


# --- the Hopper plan: lane axis, tiles, splits ----------------------------

def _planned(graph, target, shapes):
    """The B5 kernels an executor of ``target`` plans at ``shapes`` (none
    run): [(lowering, kernel object)]."""
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.executable(target, shapes)
    (ex,) = [e for (name, _), e in port._executors.items() if name == target]
    out = []
    for i in range(len(ex.target.kernels)):
        low = ex._lowering(i)
        if (i in ex._skip_kernels or i in ex.fused or i in ex.row_fused
                or low.kernel.extern is not None or not low._bounds_ok
                or low.scheduled_route() != "mapreduce"):
            continue
        out.append((low, low.scheduled_mapreduce().compiled()))
    return out


@pytest.mark.parametrize("n_p,n_q,lane_p,want", [
    # path (d)'s gamma gradient [2048, 512] -> [512]: 4 column blocks of
    # 128 adjacent floats, split in 64 chunks of 32 rows
    (512, 2048, True, dict(grid=(4, 64), block_p=128, block_q=32, splits=64,
                           chunk=32, combine_grid=(8,), block_s=64,
                           block_pc=64, num_warps=8)),
    # path (d)'s row sums [2048, 2048] -> [2048]: 512 programs, no split
    (2048, 2048, False, dict(grid=(512,), block_p=4, block_q=1024,
                             splits=1, num_warps=8)),
    # the calibration's row reduction 8192^2
    (8192, 8192, False, dict(grid=(2048,), block_p=4, block_q=1024,
                             splits=1)),
    # the scalar all-reduce of 8192 positions: 8 chunks of 1024
    (1, 8192, False, dict(grid=(1, 8), block_p=1, block_q=1024, splits=8,
                          combine_grid=(1,))),
    # a column sum too short to split (3 blocks of rows a program)
    (64, 192, True, dict(grid=(1,), block_p=64, block_q=64, splits=1)),
    # maps: 1024 elements a program (4 warps) at 8192^2 and path (d)'s
    # [2048, 2048]; fewer where that leaves fewer than two programs an SM
    (8192 * 8192, 0, False, dict(grid=(65536,), block_p=1024,
                                 num_warps=4)),
    (2048 * 2048, 0, False, dict(grid=(4096,), block_p=1024)),
    (300000, 0, False, dict(grid=(293,), block_p=1024, num_warps=4)),
    # the tiny map [16, 64], and 256 elements a program at the least
    (1024, 0, False, dict(grid=(4,), block_p=256, num_warps=1)),
    (100000, 0, False, dict(grid=(196,), block_p=512, num_warps=2)),
])
def test_planner_follows_layout_and_splits(n_p, n_q, lane_p, want):
    """The tiles follow the stride-1 axis, a reduction whose output gives
    fewer than two programs an SM (132) is split when a program would walk
    4 or more blocks of it, and a map takes as many elements a program as
    still gives two programs an SM, from 256 to 1024."""
    plan = ops_mapreduce.plan_blocks(n_p, n_q, lane_p)
    assert {k: plan[k] for k in want} == want
    if n_q:
        assert plan["lane"] == ("p" if lane_p else "q")
        assert plan["splits"] * plan["chunk"] >= n_q
        assert (plan["splits"] - 1) * plan["chunk"] < n_q
        assert plan["block_p"] * plan["block_q"] <= 4096
    else:
        assert plan["splits"] == 1


def test_head_step_plans_take_the_lane_axis():
    """Path (d)'s train step at its full width, planned: the gamma
    gradient reduces the strided axis of [2048, 512] operands and so
    takes the column tile and the split; the row sums reduce the stride-1
    axis; the maps take 1024 elements a program, their reads and write
    addressed by the flat position."""
    from chip_smoke import HEAD, transformer_head

    kernels = _planned(transformer_head(egt, HEAD["dim"], HEAD["vocab"]),
                       "train", {"x": [HEAD["rows"], HEAD["dim"]],
                                 "labels": [HEAD["rows"], HEAD["vocab"]]})
    assert len(kernels) == 5
    seen = {}
    for low, kern in kernels:
        mr = low.scheduled_mapreduce()
        lane = ops_mapreduce.lane_axis(mr)
        out = tuple(low.shapes[low.kernel.write.tensor])
        if out == (HEAD["dim"],):
            assert lane in mr.p_axes and kern.plan["lane"] == "p"
            assert kern.plan["grid"] == (4, 64)
            assert "egt_mapreduce_combine" in kern.source
            seen["gamma"] = kern.plan
        elif len(out) == 1:
            assert lane in mr.q_axes and kern.plan["lane"] == "q"
            assert kern.plan["grid"] == (512,) and kern.plan["splits"] == 1
            seen.setdefault("row sums", []).append(kern.plan)
        else:
            assert kern.plan["block_p"] == 1024 and not mr.q_axes
            assert "tl.load(x0_ptr + p, mask=p_ok" in kern.source
            assert "    o = p\n" in kern.source
            seen.setdefault("maps", []).append(kern.plan)
    assert len(seen["row sums"]) == 2 and len(seen["maps"]) == 2


def test_loads_of_program_axes_are_hoisted():
    """A read that varies over no reduced axis (``b[y]`` of
    ``out[y] = exp(a[y, x]) + b[y]``) loads once, before the walk; the
    reads of reduced axes load inside it."""
    source = _kernel_of(MAPREDUCE_FAMILIES["inblock_reduction"]) \
        .compiled().source
    head, walk = source.split("    for q_start in range(")
    assert "tl.load(x1_ptr + P0, mask=P_ok" in head
    assert "tl.load(x0_ptr" in walk and "x1_ptr" not in walk


def test_split_reduction_past_int32_indexes_in_int64():
    """A split column sum over more than 2^31 - 1 elements computes its
    chunk's start, positions and partial addresses in int64 (planned
    here, never allocated)."""
    graph, _ = fam_column_reduction(egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.executable("out", {"a": [2 ** 22, 1024], "b": [2 ** 22, 1024]})
    (ex,) = port._executors.values()
    (low,) = [ex._lowering(i) for i in range(len(ex.target.kernels))]
    kern = low.scheduled_mapreduce().compiled()
    assert kern.plan["splits"] > 1
    source = kern.source
    assert f"q_lo = tl.program_id(1).to(tl.int64) * {kern.plan['chunk']}" \
        in source
    assert "s = s0 + tl.arange(0, 64).to(tl.int64)" in source
    builtins.compile(source, "int64", "exec")


# --- the launch table (utils/launcher.py) ---------------------------------

def test_launch_table_follows_each_function_signature():
    """Each launch's argument slots are read off the generated function's
    parameters: outputs, previous values, operands (by their index among
    the op's tensors, ``kern.args``), buffers by name, the epoch."""
    split = _kernel_of(fam_column_reduction).compiled()
    tab = split.launch_table()
    ops = [("op", split.args.index(t)) for t in split.tids]
    assert tab["buffers"] == [{"name": "part", "dtype": torch.float32,
                               "numel": split.plan["part"],
                               "mode": "empty"}]
    main, combine = tab["steps"]
    assert main["fn"] == "egt_mapreduce" and main["grid"] == (1, 16, 1)
    assert main["slots"] == [("buf", 0)] + ops + [("epoch", 0)]
    assert combine["fn"] == "egt_mapreduce_combine"
    assert combine["slots"] == [("out", 0), ("buf", 0)]
    assert combine["num_warps"] == split.plan["combine_warps"]

    scatter = _kernel_of(fam_scatter_add).compiled()
    tab = scatter.launch_table()
    names = [b["name"] for b in tab["buffers"]]
    assert names == ["key", "skey", "perm", "seg", "part", "cnt"]
    assert [b["mode"] for b in tab["buffers"]] == [
        "empty", "made", "made", "made", "empty", "zeros"]
    keys, group, walk = tab["steps"]
    ops = [("op", scatter.args.index(t)) for t in scatter.tids]
    assert keys["slots"] == [("buf", 0)] + ops + [("epoch", 0)]
    assert group == {"kind": "group", "keys": 0, "sorted": 1, "perm": 2,
                     "offsets": 3, "K": scatter.plan["K"]}
    assert walk["slots"] == ([("out", 0)] + [("buf", names.index(n)) for n in
                             ("part", "cnt", "skey", "perm", "seg")]
                             + ops + [("epoch", 0)])

    from exprgrad_torch.utils import launcher
    assert launcher.slot("r1_ptr", {}, []) == ("prev", 1)
    assert launcher.slot("o2_ptr", {}, []) == ("out", 2)
    assert launcher.slot("x1_ptr", {1: 4}, []) == ("op", 4)
    with pytest.raises(ValueError, match="names no output"):
        launcher.slot("lse_ptr", {}, [])


def test_launch_table_of_an_accumulating_write_passes_prev():
    """A write that accumulates into its previous value passes it right
    after the output (``out_ptr, prev_ptr``), in the kernel and in the
    combine of a split."""
    from chip_smoke import HEAD, transformer_head

    kernels = _planned(transformer_head(egt, 32, 64), "train",
                       {"x": [1024, 32], "labels": [1024, 64]})
    assert not all(kern.fresh for _, kern in kernels)
    for low, kern in kernels:
        last = kern.launch_table()["steps"][-1]["slots"]
        want = [("out", 0)] if kern.fresh else [("out", 0), ("prev", 0)]
        assert last[:len(want)] == want
        assert ("prev", 0) not in last[len(want):]


def test_hidden_parameters_and_their_sizes():
    """A compiled function's parameters past the table's slots are
    Triton's hidden scratch pointers (two in Triton 3.6), passed as null;
    a size that disagrees with the slots raises, naming the function."""
    from exprgrad_torch.utils import launcher

    slots = [("out", 0), ("op", 1), ("op", 2), ("epoch", 0)]
    assert launcher.check_params([8, 8, 8, 4, 8, 8], slots, "f") == 6
    assert launcher.check_params([8, 8, 8, 4], slots, "f") == 4
    with pytest.raises(RuntimeError, match="f takes parameters"):
        launcher.check_params([8, 8, 8, 8, 8, 8], slots, "f")
    with pytest.raises(RuntimeError, match="f takes parameters"):
        launcher.check_params([8, 8, 8, 4, 4], slots, "f")
    with pytest.raises(RuntimeError, match="f takes parameters"):
        launcher.check_params([8, 8, 4], slots, "f")
    kern = _kernel_of(fam_column_reduction).compiled()
    bufs, steps, names = launcher.encode(
        kern.launch_table(), {"egt_mapreduce": (11, 256, 0, 6),
                              "egt_mapreduce_combine": (12, 128, 64, 4)},
        {"egt_mapreduce": "a.py:egt_mapreduce",
         "egt_mapreduce_combine": "a.py:egt_mapreduce_combine"})
    assert bufs == [6, kern.plan["part"], 0]
    op0, op1 = (kern.args.index(t) for t in kern.tids)
    assert steps == [0, 11, 1, 16, 1, 256, 0, 6, 4, 3, 0, 2, op0, 2, op1,
                     4, 0,
                     0, 12, 1, 1, 1, 128, 64, 4, 2, 0, 0, 3, 0]
    assert names == "a.py:egt_mapreduce\na.py:egt_mapreduce_combine\n"


def test_operands_off_sixteen_bytes_are_copied():
    """Triton compiles every pointer for 16-byte alignment: an operand or
    previous value at another address (a view at an odd offset) is
    copied, an aligned contiguous one passes as it is."""
    from exprgrad_torch.utils import launcher

    base = torch.arange(40, dtype=torch.float32)
    whole = base[:32]
    assert launcher.aligned(whole).data_ptr() == whole.data_ptr()
    view = base[1:33]
    assert view.data_ptr() % 16
    got = launcher.aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    col = base[:32].view(8, 4).t()
    assert launcher.aligned(col).is_contiguous()


# --- the template under a numpy emulation of Triton -----------------------

from test_torch_segments import emulated  # noqa: E402,F401  (the fixture)


def _run_template(kern, tensors, epoch):
    """``mapreduce_impl``'s launch table in Python, each launch through
    the emulated Triton (tests/test_torch_segments.py)."""
    from exprgrad_torch.utils import launcher, triton_build

    kern.handles.clear()
    prev = tensors[kern.out_tid]
    out = torch.empty_like(prev)
    launcher.run_table(
        kern.launch_table(), lambda name: triton_build.handle(kern, name),
        [out], [None if kern.fresh else prev.contiguous()],
        {i: tensors[t] for i, t in enumerate(kern.args)}, epoch)
    return out


TEMPLATE_FAMILIES = sorted(name for name in MAPREDUCE_FAMILIES
                           if "scatter" not in name)


@pytest.mark.parametrize("family", TEMPLATE_FAMILIES)
def test_template_runs_as_the_plain_version(family, emulated, monkeypatch):
    """Every map/reduce family's generated source, run under the numpy
    emulation of Triton through its launch table, against the plain
    version on the same tensors, and the same bits twice."""
    graph, args = MAPREDUCE_FAMILIES[family](egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.epoch = 3
    ran = []
    real = ops_mapreduce.mapreduce_impl

    def impl(kern, tensors, epoch):
        want = real(kern, tensors, epoch)
        got = _run_template(kern, tensors, epoch)
        assert torch.equal(got, _run_template(kern, tensors, epoch))
        assert_same(family, got.numpy(), want.numpy(),
                    dict(rtol=1e-5, atol=1e-5))
        ran.append(kern.plan)
        return want

    monkeypatch.setattr(ops_mapreduce, "mapreduce_impl", impl)
    port.call("out", args)
    assert len(ran) == 1
    if family == "column_reduction":
        assert ran[0]["splits"] == 16 and ran[0]["lane"] == "p"


def test_head_step_kernels_run_as_the_plain_version(emulated, monkeypatch):
    """Path (d)'s train step at 1024 rows of width 32 and a vocabulary of
    64: each of its five B5 kernels under the emulation against the plain
    version on the tensors the step hands it; the gamma gradient (a
    column sum over 1024 rows) splits."""
    from chip_smoke import transformer_head

    port = egt.compile(transformer_head(egt, 32, 64), seed=0,
                       schedule_mode="force", device="cpu")
    rng = np.random.default_rng(4)
    batch = {"x": rng.standard_normal((1024, 32), dtype=np.float32),
             "labels": np.eye(64, dtype=np.float32)[
                 rng.integers(0, 64, 1024)]}
    port.epoch = 1
    ran = []
    real = ops_mapreduce.mapreduce_impl

    def impl(kern, tensors, epoch):
        want = real(kern, tensors, epoch)
        got = _run_template(kern, tensors, epoch)
        assert_same("head step", got.numpy(), want.numpy(),
                    dict(rtol=1e-5, atol=1e-5))
        ran.append(kern.plan)
        return want

    monkeypatch.setattr(ops_mapreduce, "mapreduce_impl", impl)
    port.apply("train", batch)
    assert len(ran) == 5
    assert [p["lane"] for p in ran if p["splits"] > 1] == ["p"]


@pytest.mark.parametrize("kind", ["mapreduce", "rowchain"])
def test_first_call_runs_the_table_and_registers_it(kind, emulated,
                                                    monkeypatch):
    """A kernel's first call on a device (``generated._first``, which the
    C++ implementation calls when it holds no table): the launch table
    runs in Python, here through the emulated Triton on CPU tensors, gives
    the plain version's values, and is handed to the launcher with the
    kernel's dtype and fresh flags; an operand of another dtype raises."""
    from chip_smoke import softmax_chain
    from exprgrad_torch.ops import generated
    from exprgrad_torch.utils import launcher

    if kind == "mapreduce":
        graph, args = fam_column_reduction(egt)
    else:
        graph, args = softmax_chain(egt, {"y": 8}, rows=16, cols=32)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    want = port.call("out", args)
    (ex,) = port._executors.values()
    if kind == "mapreduce":
        (low,) = ex._lowerings.values()
        kern = low.scheduled_mapreduce().compiled()
        n_out = 1
    else:
        (chain,) = ex.row_fused.values()
        kern = chain.compiled()
        n_out = len(kern.out_tids)
    prog = port.program
    inputs = {prog.inputs[n]: torch.from_numpy(v) for n, v in args.items()}
    tensors = [inputs.get(t, torch.zeros(ex.shapes[t])) for t in kern.args]
    registered = []
    monkeypatch.setattr(launcher, "register",
                        lambda *a: registered.append(a))
    kern.handles.clear()
    outs = generated._first(kind, kern.spec, tensors, n_out, 3)
    final = prog.targets["out"].output
    got = outs[0] if kind == "mapreduce" else outs[
        kern.out_tids.index(final)]
    assert_same(kind, got.numpy(), want, dict(rtol=1e-5, atol=1e-5))
    (op, spec, device, tab, compiled, dtype, fresh, path), = registered
    assert (op, spec, dtype) == (kind, kern.spec, torch.float32)
    assert tab is kern.launch_table() and path.suffix == ".py"
    assert sorted(compiled) == sorted(
        s["fn"] for s in tab["steps"] if s["kind"] == "launch")
    assert len(fresh) == n_out
    op_index = next(i for i, t in enumerate(kern.args)
                    if t in kern.tids and i >= n_out)
    tensors[op_index] = tensors[op_index].double()
    with pytest.raises(ValueError, match="the kernel takes torch.float32"):
        generated._first(kind, kern.spec, tensors, n_out, 3)
