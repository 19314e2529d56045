"""Port parity: kernel lowering and execution (exprgrad_torch/backend).

Each DSL program runs three ways — the port on the CPU, the JAX package
(``backend="jax"``) and the numpy interpreter (``backend="interp"``) — on
the same numpy inputs.  The families are those the serving model's
predict target needs (einsum, structured and direct general writes,
embedding gathers through ``to_index``, bounded iterators, max-accumulated
softmax) plus truncated index arithmetic with negative operands, computed-
index scatters and the JAX package's random differential-fuzz kernels.
Tolerances: float64 ``rtol=1e-10``; float32 ``rtol=1e-5``.
"""

import warnings

import numpy as np
import pytest

import exprgrad_torch as egt
from exprgrad_tpu import (Fun, ModelRuntimeError, ScheduleWarning, compile,
                          exp, input, irange, iters, maximum, param, select,
                          to_index, to_scalar, wrap)
from exprgrad_tpu.models import xor_mlp
from exprgrad_tpu.models.transformer import _softmax_last
from test_fuzz import _random_kernel

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


def _three_ways(target, args, dtype="float64", name="out"):
    port = egt.compile(target, dtype=dtype, device="cpu")
    got = port.call(name, args)
    for backend in ("jax", "interp"):
        want = compile(target, dtype=dtype, backend=backend).call(name, args)
        np.testing.assert_allclose(got, want,
                                   **(F64 if dtype == "float64" else F32))
    return port


def _matmul():
    y, x, it = iters("y", "x", "it")
    out = Fun("out")
    out[y, x] = input("a")[y, it] * input("b")[it, x] * 0.5
    rng = np.random.default_rng(0)
    return out, {"a": rng.standard_normal((5, 7)),
                 "b": rng.standard_normal((7, 3))}


def _batched_broadcast():
    # per-head projection (the attention layer's "ntc,hcd->nhtd") with a
    # write axis no read covers, then a transposed read
    n, h, t, c, d = iters("n", "h", "t", "c", "d")
    proj = Fun("proj")
    proj[n, h, t, d] = input("x")[n, t, c] * input("w")[h, c, d]
    n, h, t, d = iters("n", "h", "t", "d")
    out = Fun("out")
    out[n, h, t, d] = proj[n, h, t, d] * input("g")[d, h] - proj[n, h, t, d]
    rng = np.random.default_rng(1)
    return out, {"x": rng.standard_normal((2, 4, 3)),
                 "w": rng.standard_normal((2, 3, 5)),
                 "g": rng.standard_normal((5, 2))}


def _direct_reduce():
    y, x = iters("y", "x")
    out = Fun("out")
    out[y] = exp(input("a")[y, x] * 0.3) / (input("a")[y, x] ** 2 + 1.0)
    return out, {"a": np.random.default_rng(2).standard_normal((6, 9))}


def _raw_elementwise():
    it = iters("it")
    out = Fun("out")
    a = input("a")
    out.raw[it] = select(a.raw[it] >= 0.0, a.raw[it], a.raw[it] * 0.1)
    out.copy_shape(a)
    return out, {"a": np.random.default_rng(3).standard_normal((4, 5))}


def _strided_write():
    y, x = iters("y", "x")
    out = Fun("out")
    a = input("a")
    out[2 * y + 1, x] = a[y, x]
    out.with_shape([a.shape[0] * 2 + 1, a.shape[1]])
    return out, {"a": np.random.default_rng(4).standard_normal((4, 3))}


def _grouped_write():
    y, x = iters("y", "x")
    out = Fun("out")
    a = input("a")
    out[y // 2, x] = a[y, x] * a[y, x]
    out.with_shape([a.shape[0] // 2, a.shape[1]])
    return out, {"a": np.random.default_rng(5).standard_normal((8, 3))}


def _pool_read():
    # separable reads: strided 2*y+dy and grouped y // 2
    y, x = iters("y", "x")
    dy = irange("dy", 0, 2)
    a = input("a")
    out = Fun("out")
    out[y, x] = a[2 * y + dy, x] + input("b")[y // 2, x]
    out.with_shape([a.shape[0] // 2, a.shape[1]])
    rng = np.random.default_rng(6)
    return out, {"a": rng.standard_normal((8, 3)),
                 "b": rng.standard_normal((2, 3))}


def _embedding_gather():
    n, t, d = iters("n", "t", "d")
    x = Fun("out")
    x[n, t, d] = input("emb")[to_index(input("tok")[n, t]), d]
    n, d = iters("n", "d")
    t = irange("t", 0, input("tok").shape[1])
    x[n, t, d] = input("pos")[t, d]
    x.with_shape([input("tok").shape[0], input("tok").shape[1],
                  input("emb").shape[1]])
    rng = np.random.default_rng(7)
    return x, {"emb": rng.standard_normal((11, 4)),
               "pos": rng.standard_normal((16, 4)),
               "tok": rng.integers(0, 11, (3, 5)).astype(np.float64)}


def _bounded_shift():
    a = input("a")
    y = irange("y", 0, a.shape[0] - 1)
    out = Fun("out")
    out[y] = a[y + 1] - a[y]
    out.with_shape([a.shape[0] - 1])
    return out, {"a": np.random.default_rng(8).standard_normal(9)}


def _triangular_sum():
    a = input("a")
    y = irange("y", 0, a.shape[0])
    x = irange("x", 0, y + 1)
    out = Fun("out")
    out[y] = a[y, x] * a[x, y]
    out.with_shape([a.shape[0]])
    return out, {"a": np.random.default_rng(9).standard_normal((6, 6))}


def _triangular_max():
    a = input("a")
    y = irange("y", 0, a.shape[0])
    x = irange("x", y, a.shape[1])
    out = Fun("out")
    out.maximize[y] = a[y, x]
    out.with_shape([a.shape[0]])
    return out, {"a": np.random.default_rng(10).standard_normal((5, 7))}


def _softmax():
    n, t, v = iters("n", "t", "v")
    logits = Fun("logits")
    logits[n, t, v] = input("a")[n, t, v] * 3.0
    out = _softmax_last(logits)
    out.name = "out"
    return out, {"a": np.random.default_rng(11).standard_normal((2, 3, 7))}


def _trunc_div_mod():
    i = irange("i", 0, 15)
    a = input("a")
    out = Fun("out")
    out[i] = (to_scalar((i - 7) // 3) * 100.0 + to_scalar((i - 7) % 3) * 10.0
              + to_scalar(wrap(i - 7, 3)) + a[i] * 0.0)
    out.with_shape([15])
    return out, {"a": np.zeros(15)}


def _negative_index_read():
    # (i - 6) // 4 is -1 for i in 1..5: a negative index wraps
    i = irange("i", 0, 12)
    a = input("a")
    out = Fun("out")
    out[i] = a[(i - 6) // 4 + 1] + a[(i - 6) % 4 + 3]
    out.with_shape([12])
    return out, {"a": np.random.default_rng(12).standard_normal(7)}


def _scatter_add():
    i = iters("i")
    out = Fun("out")
    out[to_index(input("idx")[i])] = input("vals")[i]
    out.with_shape([6])
    rng = np.random.default_rng(13)
    return out, {"idx": rng.integers(0, 6, 20).astype(np.float64),
                 "vals": rng.standard_normal(20)}


def _scatter_max():
    i = iters("i")
    out = Fun("out")
    out.maximize[to_index(input("idx")[i])] = input("vals")[i]
    out.with_shape([5])
    rng = np.random.default_rng(14)
    return out, {"idx": np.arange(20.0) % 5,
                 "vals": rng.standard_normal(20)}


def _select_max():
    y, x = iters("y", "x")
    a, b = input("a"), input("b")
    out = Fun("out")
    out[y, x] = select(a[y, x] < b[y, x], maximum(a[y, x], 0.0),
                       b[y, x] * to_scalar(x))
    rng = np.random.default_rng(15)
    return out, {"a": rng.standard_normal((4, 5)),
                 "b": rng.standard_normal((4, 5))}


FAMILIES = {f.__name__[1:]: f for f in (
    _matmul, _batched_broadcast, _direct_reduce, _raw_elementwise,
    _strided_write, _grouped_write, _pool_read, _embedding_gather,
    _bounded_shift, _triangular_sum, _triangular_max, _softmax,
    _trunc_div_mod, _negative_index_read, _scatter_add, _scatter_max,
    _select_max,
)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_float64(family):
    graph, args = FAMILIES[family]()
    _three_ways(graph.target("out"), args)


@pytest.mark.parametrize("family", ["matmul", "batched_broadcast",
                                    "embedding_gather", "softmax",
                                    "triangular_max", "scatter_add"])
def test_family_float32(family):
    graph, args = FAMILIES[family]()
    args = {k: v.astype(np.float32) for k, v in args.items()}
    _three_ways(graph.target("out"), args, dtype="float32")


def test_trunc_div_mod_values():
    """Nim semantics: -7 // 3 == -2 and -7 % 3 == -1 (truncated), while
    wrap(-7, 3) == 2 (floored)."""
    graph, args = _trunc_div_mod()
    got = egt.compile(graph.target("out"), dtype="float64",
                      device="cpu").call("out", args)
    i = np.arange(15) - 7
    q = np.trunc(i / 3)
    want = q * 100 + (i - q * 3) * 10 + np.mod(i, 3)
    np.testing.assert_array_equal(got, want)


def test_lowering_paths_match_jax_package():
    graph, args = FAMILIES["embedding_gather"]()
    target = graph.target("out")
    port = egt.compile(target, dtype="float64", device="cpu")
    port.call("out", args)
    ref = compile(target, dtype="float64", backend="jax")
    ref.call("out", args)
    assert port.lowering_stats("out") == ref.lowering_stats("out")


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_forward_matches_interp(seed):
    rng = np.random.default_rng(seed)
    graph, arrays = _random_kernel(rng, smooth=False)
    target = graph.target("out")
    got = egt.compile(target, dtype="float64", device="cpu").call(
        "out", arrays)
    want = compile(target, dtype="float64", backend="interp").call(
        "out", arrays)
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_gradients_match_interp(seed):
    """Derived backward kernels: scatter-add gradients of shifted,
    strided and grouped reads."""
    rng = np.random.default_rng(1000 + seed)
    graph, arrays = _random_kernel(rng, smooth=True)
    it = iters("it")
    loss = Fun()
    loss[0] = graph.raw[it] * graph.raw[it]
    bw = loss.target("loss").backwards()
    wrt = sorted(arrays)[0]
    target = bw.grad(input(wrt)).target("grad")
    got = egt.compile(target, dtype="float64", device="cpu").call(
        "grad", arrays)
    want = compile(target, dtype="float64", backend="interp").call(
        "grad", arrays)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def test_xor_training_matches_both_backends():
    """20 SGD steps through apply("train"): updated parameters swap back
    into the model after every step, as in the JAX package."""
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float64)
    y = np.array([[0], [1], [1], [0]], np.float64)
    graph = xor_mlp(rate=0.5)
    port = egt.compile(graph, dtype="float64", seed=0, device="cpu")
    refs = [compile(graph, dtype="float64", seed=0, backend=b)
            for b in ("jax", "interp")]
    for ref in refs:
        for tid, value in ref.params.items():
            np.testing.assert_array_equal(port.params[tid].numpy(),
                                          np.asarray(value))
    for _ in range(20):
        for m in (port, *refs):
            m.apply("train", {"x": x, "y": y})
    for ref in refs:
        for tid, value in ref.params.items():
            np.testing.assert_allclose(port.params[tid].numpy(),
                                       np.asarray(value), **F64)
        np.testing.assert_allclose(port.call("predict", {"x": x}),
                                   ref.call("predict", {"x": x}), **F64)
    loss0 = egt.compile(graph, dtype="float64", seed=0,
                        device="cpu").call("loss", {"x": x, "y": y})
    assert port.call("loss", {"x": x, "y": y})[0] < loss0[0]


def test_fit_runs_batches_through_the_port():
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]] * 4, np.float64)
    y = np.array([[0], [1], [1], [0]] * 4, np.float64)
    port = egt.compile(xor_mlp(rate=0.5), dtype="float64", seed=1,
                       device="cpu")
    ref = compile(xor_mlp(rate=0.5), dtype="float64", seed=1,
                  backend="interp")
    for m in (port, ref):
        m.fit("train", {"x": x, "y": y}, batch_size=4, log_status=False)
    assert port.epoch == ref.epoch == 1
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(), value, **F64)
    # the scan epoch (the interpreter runs it batch by batch)
    for m in (port, ref):
        m.fit("train", {"x": x, "y": y}, batch_size=4, log_status=False,
              scan_batches=True)
    assert port.epoch == ref.epoch == 2
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(), value, **F64)


def _scheduled_matmul():
    y, x, it = iters("y", "x", "it")
    out = Fun("out")
    out[y, x] = input("a")[y, it] * param([4, 8])[it, x]
    out.schedule(tile={"y": 8, "x": 8})
    return out.target("out")


def test_schedule_falls_back_with_warning():
    target = _scheduled_matmul()
    a = np.random.default_rng(0).standard_normal((8, 4))
    port = egt.compile(target, dtype="float64", seed=0, device="cpu")
    with pytest.warns(ScheduleWarning, match="no Hopper kernel"):
        got = port.call("out", {"a": a})
    assert port.lowering_stats("out")["schedule-fallback"] == 1
    want = compile(target, dtype="float64", seed=0,
                   backend="interp").call("out", {"a": a})
    np.testing.assert_allclose(got, want, **F64)

    quiet = egt.compile(target, dtype="float64", seed=0, device="cpu",
                        schedule_mode="ignore")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.call("out", {"a": a})
    forced = egt.compile(target, dtype="float64", seed=0, device="cpu",
                         schedule_mode="force")
    with pytest.raises(ModelRuntimeError, match="cannot be forced"):
        forced.call("out", {"a": a})


def test_jax_only_methods_raise():
    port = egt.compile(_scheduled_matmul(), device="cpu", seed=0)
    for call in (lambda: port.export_compiled("out", {"a": [8, 4]}),
                 lambda: port.save_hlo("x.hlo", "out", {"a": [8, 4]}),
                 lambda: port.profile("out", {}, "logdir"),
                 lambda: port.quantize_weights(),
                 lambda: port.autotune("out")):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()


def test_astype_executable_and_precision():
    graph, args = _matmul()
    target = graph.target("out")
    port = egt.compile(target, dtype="float64", device="cpu")
    f32 = port.astype("float32")
    assert f32.call("out", args).dtype == np.float32
    fn = port.executable("out", {n: a.shape for n, a in args.items()})
    np.testing.assert_allclose(fn(args).numpy(), port.call("out", args),
                               **F64)
    with pytest.raises(ValueError, match="precision"):
        egt.compile(target, device="cpu", precision="fastest")
