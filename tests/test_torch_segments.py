"""Port parity: the owner-computes scatter of kernel B5
(exprgrad_torch/ops/mapreduce.py ``emit_scatter``, ``group``,
``scatter``).

The CPU has no Triton, so the generated source runs here under a small
numpy emulation of the ``triton.language`` calls it makes (one program
at a time, in grid order; integer ``//`` and ``%`` truncate toward zero,
as Triton's do), through the wrapper's own launch sequence: the keys
kernel, the grouping (``torch.sort`` and ``torch.searchsorted`` of the
keys), then the walk of each destination's segment in position order.

* the grouping against numpy's stable ``argsort``, out-of-range keys,
  skewed keys and a 128K-row table at 1M positions included;
* every scatter family of ``MAPREDUCE_FAMILIES`` (add, max, min, the
  pure-iterator ``out[i, (i + j) mod n]``), bench.py's embedding-gradient
  shape cut to size, the banded histogram of path (c) and the gradient of
  a gather (a scatter into a parameter's gradient, reading the upstream
  gradient) against ``backend="jax"`` and ``backend="interp"`` at
  ``rtol=1e-5, atol=1e-6`` (float32 sums in another order);
* indices outside the table are dropped, all positions on one
  destination, and 90% on one destination;
* two runs give the same bits;
* every size reaches the kernel: positions past int32, rows past int16
  and int32 keys, outputs past 2^31 elements.
"""

import builtins
import sys
import types

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers  # noqa: F401
import exprgrad_tpu
import exprgrad_tpu.layers  # noqa: F401
from chip_smoke import (MAPREDUCE_FAMILIES, assert_same, fuzz_case,
                        scatter_add_graph)
from exprgrad_tpu import compile
from exprgrad_torch.ops import mapreduce as ops_mapreduce

F32 = dict(rtol=1e-5, atol=1e-6)

pytestmark = pytest.mark.filterwarnings(
    "ignore::exprgrad_tpu.ScheduleWarning",
    "ignore::exprgrad_torch.ScheduleWarning",
)


# --- a numpy emulation of the Triton calls the emitter writes -------------

class T(np.ndarray):
    """A block: numpy with Triton's ``.to`` and truncating ``//``, ``%``."""

    def to(self, dtype):
        if np.issubdtype(dtype, np.integer) and self.dtype.kind == "f":
            return np.trunc(self).astype(dtype).view(T)
        return np.asarray(self).astype(dtype).view(T)

    def __floordiv__(self, other):
        a, b = np.asarray(self), np.asarray(other)
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            return np.floor_divide(a, b).view(T)
        return ((a - np.fmod(a, b)) // b).view(T)

    def __mod__(self, other):
        a, b = np.asarray(self), np.asarray(other)
        return np.fmod(a, b).view(T)


def _t(x):
    return np.asarray(x).view(T)


class Ptr:
    """A pointer block: a flat array and offsets into it."""

    def __init__(self, base, off=0):
        self.base, self.off = base, off

    def __add__(self, off):
        return Ptr(self.base, np.asarray(self.off) + np.asarray(off))

    __radd__ = __add__


def _load(ptr, mask=None, other=None, cache_modifier=None):
    del cache_modifier
    off = np.asarray(ptr.off)
    if mask is None:
        return _t(ptr.base[off])
    mask, off = np.broadcast_arrays(np.asarray(mask), off)
    got = ptr.base[np.where(mask, off, 0)]
    return _t(np.where(mask, got, np.asarray(other, got.dtype)))


def _store(ptr, value, mask=None):
    off = np.asarray(ptr.off)
    value = np.broadcast_to(np.asarray(value), off.shape)
    if mask is None:
        ptr.base[off] = value
        return
    mask = np.broadcast_to(np.asarray(mask), off.shape)
    ptr.base[off[mask]] = value[mask]


def _atomic_add(ptr, value):
    """A scalar int32 atomic: returns the old value (programs run one at
    a time here, so the last to arrive is the last in grid order)."""
    off = int(np.asarray(ptr.off))
    old = ptr.base[off].copy()
    ptr.base[off] += value
    return _t(old)


def _reduce(fn):
    return lambda x, axis: _t(fn(np.asarray(x), axis=axis))


class _Grid:
    current = (0, 0, 0)


class _Kernel:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):  # a jit function called from another
        return self.fn(*args)

    def __getitem__(self, grid):
        grid = tuple(grid) + (1,) * (3 - len(grid))

        def run(*args, num_warps=4):
            del num_warps
            args = [Ptr(a.numpy().reshape(-1)) if isinstance(a, torch.Tensor)
                    else a for a in args]
            for x in range(grid[0]):
                for y in range(grid[1]):
                    for z in range(grid[2]):
                        _Grid.current = (x, y, z)
                        self.fn(*args)
        return run


def _language():
    tl = types.ModuleType("triton.language")
    tl.float32, tl.int16, tl.int32, tl.int64 = (
        np.float32, np.int16, np.int32, np.int64)
    tl.program_id = lambda axis: _t(np.int64(_Grid.current[axis]))
    tl.arange = lambda lo, hi: _t(np.arange(lo, hi))
    tl.zeros = lambda shape, dtype: _t(np.zeros(shape, dtype))
    tl.full = lambda shape, value, dtype: _t(np.full(shape, value, dtype))
    tl.where = lambda c, a, b: _t(np.where(np.asarray(c), a, b))
    tl.load, tl.store = _load, _store
    tl.sum = _reduce(np.sum)
    tl.max = _reduce(np.max)
    tl.min = _reduce(np.min)
    tl.atomic_add = _atomic_add
    tl.debug_barrier = lambda: None
    tl.constexpr = int
    tl.maximum = lambda a, b: _t(np.maximum(a, b))
    tl.minimum = lambda a, b: _t(np.minimum(a, b))
    tl.div_rn = lambda a, b: _t(np.float32(1) * np.asarray(a) / b)
    tl.sqrt_rn = lambda a: _t(np.sqrt(a))
    libdevice = types.ModuleType("triton.language.extra.libdevice")
    for name, fn in (("exp", np.exp), ("log", np.log), ("log2", np.log2),
                     ("log10", np.log10), ("sin", np.sin), ("cos", np.cos),
                     ("pow", np.power)):
        setattr(libdevice, name, lambda *a, fn=fn: _t(fn(*a)))
    extra = types.ModuleType("triton.language.extra")
    extra.libdevice = libdevice
    tl.extra = extra
    return tl, extra


def _jit(fn=None, **_):
    return _Kernel(fn) if fn is not None else _Kernel


@pytest.fixture
def emulated(monkeypatch, tmp_path):
    """The numpy emulation in place of ``triton``: the port's loader then
    writes and imports the generated sources (into a temporary directory)
    and its launches run them on CPU tensors."""
    from exprgrad_torch.utils import triton_build

    tl, extra = _language()
    triton = types.ModuleType("triton")
    triton.jit = _jit
    triton.language = tl
    for name, mod in (("triton", triton), ("triton.language", tl),
                      ("triton.language.extra", extra)):
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(triton_build, "TRITON_DIR", tmp_path)
    monkeypatch.setattr(triton_build, "_loaded", {})
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "cache"))


def run_scatter(kern, tensors, epoch):
    """``mapreduce_impl``'s scatter path (``ops.mapreduce.scatter``) on
    CPU tensors with the emulated kernels."""
    kern.handles.clear()
    ops = [tensors[t].contiguous() for t in kern.tids]
    prev = tensors[kern.out_tid]
    out = torch.empty_like(prev)
    prevs = () if kern.fresh else (prev.contiguous(),)
    ops_mapreduce.scatter(kern, out, prevs, ops, epoch)
    return out


# --- the grouping ---------------------------------------------------------

# name -> (rows, keys from a generator)
KEYS = {
    "uniform": (50, lambda rng: rng.integers(0, 50, 3000)),
    "out of range": (50, lambda rng: np.where(
        rng.random(3000) < 0.2, rng.choice([-3, 50, 77], 3000),
        rng.integers(0, 50, 3000))),
    "one destination": (50, lambda rng: np.full(3000, 7)),
    "90% on one": (50, lambda rng: np.where(rng.random(3000) < 0.9, 3,
                                            rng.integers(0, 50, 3000))),
    "every key out of range": (50, lambda rng: np.full(100, 50)),
    # a 128K vocabulary at 1M tokens, int32 keys
    "128K rows at 1M positions": (2 ** 17, lambda rng: rng.integers(
        -2, 2 ** 17 + 2, 2 ** 20)),
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_grouping_matches_numpy_stable_argsort(name, emulated):
    """The keys kernel and the grouping group the positions by key in
    position order, as numpy's stable argsort does, with each key's
    segment between offsets[k] and offsets[k + 1]; a key outside
    [0, v) is dropped past offsets[v].  The keys are the narrowest
    integer that holds v + 1."""
    v, make = KEYS[name]
    toks = make(np.random.default_rng(3)).astype(np.float32)
    graph = scatter_add_graph(egt, v, 8, {"i": 64})
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.executable("demb", {"tok": [len(toks)], "g": [len(toks), 8]})
    (ex,) = port._executors.values()
    (low,) = [ex._lowering(i) for i in range(len(ex.target.kernels))]
    kern = low.scheduled_mapreduce().compiled()
    prog = port.program
    tensors = {prog.inputs["tok"]: torch.from_numpy(toks),
               prog.inputs["g"]: torch.zeros(len(toks), 8)}
    ops = [tensors[t] for t in kern.tids]
    ws = ops_mapreduce.group(kern, ops, 0, torch.device("cpu"))
    assert ws["keys"].dtype == (torch.int16 if v < 2 ** 15 - 1
                                else torch.int32)
    keys = toks.astype(np.int64)
    keys = np.where((keys >= 0) & (keys < v), keys, v)
    np.testing.assert_array_equal(ws["keys"].numpy(), keys)
    counts = np.bincount(keys, minlength=v + 1)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:v + 1]
    np.testing.assert_array_equal(ws["offsets"].numpy(), offsets)
    valid = offsets[v]
    want = np.argsort(keys, kind="stable")[:valid]
    np.testing.assert_array_equal(ws["perm"].numpy()[:valid], want)


def test_segment_blocks_follow_the_mean_segment():
    """bench.py's scatter-add: 16384 positions on 2048 rows of 512
    columns walk 8 positions at a time over 128 columns."""
    assert ops_mapreduce.plan_segments(16384, 512, 2048) == (8, 128, 4)
    assert ops_mapreduce.plan_segments(1024, 0, 11) == (128, 1, 1)
    # a column block per program under the grid's 65535 second axis
    bs, bc, _ = ops_mapreduce.plan_segments(10, 2 ** 24, 10)
    assert -(-2 ** 24 // bc) <= 65535 and bs == 1


# --- the segment walk against the JAX package ----------------------------

def _embedding(m, toks=None, n=96, v=37, d=40):
    """bench.py's embedding-gradient scatter-add, cut to size."""
    rng = np.random.default_rng(5)
    graph = scatter_add_graph(m, v, d, {"i": 32, "x": 16})
    toks = rng.integers(0, v, n) if toks is None else toks
    g = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    return graph, {"tok": np.asarray(toks, np.float32), "g": g}


def _histogram(m):
    sv = m.input("sv")
    si, sj = m.iters("si", "sj")
    hist = m.Fun("hist")
    hist[(si + sj) % 11] = sv[si, sj]
    hist.with_shape([11])
    hist.schedule(tile={"si": 8})
    v = np.random.default_rng(47).normal(size=(16, 64)).astype(np.float32)
    return hist.target("hist"), {"sv": v}


def _gather_grad(m):
    """d sum(out^2) / d table of out[i, d] = table[tok[i], d]: the
    gradient is a scatter of 2 * out into the table's rows."""
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


CASES = {name: MAPREDUCE_FAMILIES[name] for name in
         ("scatter_add", "scatter_max", "scatter_min", "pure_scatter")}
CASES.update({
    "embedding": _embedding,
    "histogram": _histogram,
    "gather gradient": _gather_grad,
    # all positions on one destination, and 90% of them on one
    "one destination": lambda m: _embedding(m, np.full(96, 4)),
    "90% on one": lambda m: _embedding(m, np.where(
        np.random.default_rng(2).random(96) < 0.9, 11,
        np.random.default_rng(3).integers(0, 37, 96))),
})


def _run_emulated(port, target, args, monkeypatch):
    """The port model's target with every B5 scatter through the
    emulated kernels (the other B5 kernels run their plain version, as on
    the CPU); returns (output, scatters run)."""
    ran = []

    def impl(kern, tensors, epoch):
        if not kern.scatter:
            return ops_mapreduce.mapreduce_plain(kern, tensors, epoch)
        ran.append(kern)
        return run_scatter(kern, tensors, epoch)

    with monkeypatch.context() as patch:
        patch.setattr(ops_mapreduce, "mapreduce_impl", impl)
        out = port.call(target, args)
    return out, ran


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_walk_matches_jax(name, emulated, monkeypatch):
    build = CASES[name]
    port_graph, args = build(egt)
    ref_graph, _ = build(exprgrad_tpu)
    port = egt.compile(port_graph, seed=0, schedule_mode="force",
                       device="cpu")
    ref = compile(ref_graph, seed=0, backend="jax", schedule_mode="force")
    interp = compile(ref_graph, seed=0, backend="interp")
    for model in (port, ref, interp):
        model.epoch = 3
    targets = list(port.program.targets)
    target = "out" if "out" in targets else targets[-1]
    want = port.call(target, args)
    got, scatters = _run_emulated(port, target, args, monkeypatch)
    assert scatters
    if "one" in name:  # the long segment is cut in carried pieces
        (kern,) = scatters
        assert kern.plan["chunks"] > 1
    assert_same(name, got, np.asarray(ref.call(target, args)), F32)
    assert_same(name, got, np.asarray(interp.call(target, args)), F32)
    assert_same(name, got, want, F32)
    again, _ = _run_emulated(port, target, args, monkeypatch)
    np.testing.assert_array_equal(got, again)


def test_out_of_range_targets_are_dropped(emulated, monkeypatch):
    """A token outside [0, v) adds to no row, as the atomic design's mask
    dropped it (the plain version clamps it, as the JAX package's XLA
    path does, so the want here is numpy's)."""
    graph, args = _embedding(egt)
    toks = args["tok"].copy()
    toks[:5] = [-1, 37, 1000, -40, 36]
    args = {**args, "tok": toks}
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    got, scatters = _run_emulated(port, "demb", args, monkeypatch)
    assert len(scatters) == 1
    want = np.zeros((37, 40), np.float64)
    idx = toks.astype(np.int64)
    keep = (idx >= 0) & (idx < 37)
    np.add.at(want, idx[keep], args["g"][keep])
    np.testing.assert_allclose(got, want, **F32)


# seeds of the JAX package's computed-index fuzzer whose program scatters
# (add, max and min; keyed by one or two write dims, with and without a
# column axis)
FUZZ_SCATTERS = (1, 2, 3, 9, 12, 14, 16, 18, 20, 28, 32, 36, 37, 38, 39)


@pytest.mark.parametrize("seed", FUZZ_SCATTERS)
def test_fuzz_scatters_match_jax(seed, emulated, monkeypatch):
    port_graphs, args = fuzz_case(egt, "cmpred", seed)
    ref_graphs, _ = fuzz_case(exprgrad_tpu, "cmpred", seed)
    port = egt.compile(port_graphs, seed=0, schedule_mode="force",
                       device="cpu")
    ref = compile(ref_graphs, seed=0, backend="jax", schedule_mode="force")
    got, scatters = _run_emulated(port, "out", args, monkeypatch)
    assert len(scatters) == 1
    assert_same(f"cmpred {seed}", got, np.asarray(ref.call("out", args)),
                dict(rtol=3e-4, atol=3e-4))


def test_loader_keeps_each_function_of_a_source(emulated, monkeypatch,
                                                tmp_path):
    # (the emulated fixture points the loader at tmp_path)
    """The two kernels of one generated scatter source load as two (the
    loader keys them by source and name), and the kernel object keeps
    each handle, so a launch hashes no source."""
    from exprgrad_torch.utils import triton_build

    graph, args = MAPREDUCE_FAMILIES["scatter_add"](egt)
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.call("out", args)
    (ex,) = port._executors.values()
    (low,) = ex._lowerings.values()
    kern = low.scheduled_mapreduce().compiled()
    names = ("egt_scatter_keys", "egt_mapreduce")
    got = [triton_build.handle(kern, name) for name in names]
    assert [g[0].fn.__name__ for g in got] == list(names)
    assert all(triton_build.handle(kern, n) is g for n, g in zip(names, got))
    assert len({g[1] for g in got}) == 1 and got[0][1].parent == tmp_path

    def no_hash(*_):
        raise AssertionError("a cached launch hashed the source")

    monkeypatch.setattr(triton_build, "source_path", no_hash)
    assert triton_build.handle(kern, "egt_mapreduce") is got[-1]


@pytest.mark.parametrize("n,v,d,key", [
    (2 ** 31, 16, 8, "tl.int16"),
    (64, 2 ** 21, 8, "tl.int32"),
    (2 ** 20, 2 ** 17, 8, "tl.int32"),
    (4096, 2 ** 16, 2 ** 16, "tl.int32")])
def test_every_scatter_size_reaches_the_kernel(n, v, d, key):
    """The grouping needs memory for the positions and the rows alone, so
    the planner takes a scatter at every size (planned here, never
    allocated): 2^31 positions, 2^21 rows, a 128K vocabulary at 1M
    tokens, and an output past 2^31 elements, whose positions and
    addresses run in int64 where they pass int32."""
    graph = scatter_add_graph(egt, v, d, {"i": 64})
    port = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    port.executable("demb", {"tok": [n], "g": [n, d]})
    (ex,) = port._executors.values()
    (low,) = [ex._lowering(i) for i in range(len(ex.target.kernels))]
    mr = low.scheduled_mapreduce()
    assert (mr.ok, mr.why) == (True, "")
    source = mr.compiled().source
    assert f").to({key})" in source
    wide = n >= 2 ** 31 or v * d >= 2 ** 31
    assert ("pid = tl.program_id(0).to(tl.int64)" in source) == wide
    builtins.compile(source, "int64", "exec")
