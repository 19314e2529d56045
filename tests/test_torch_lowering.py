"""Port parity: kernel lowering and execution (exprgrad_torch/backend).

Each DSL program is built twice, with the port's front end and with the
JAX package's, and runs three ways — the port on the CPU, the JAX package
(``backend="jax"``) and the numpy interpreter (``backend="interp"``) — on
the same numpy inputs.  The random fuzz kernels are built by
tests/test_fuzz.py with the JAX package's front end and reach the port
through the checkpoint program format, which both packages read and
write.  The families are those the serving model's predict target needs
(einsum, structured and direct general writes, embedding gathers through
``to_index``, bounded iterators, max-accumulated softmax) plus truncated
index arithmetic with negative operands, computed-index scatters and the
JAX package's random differential-fuzz kernels.
Tolerances: float64 ``rtol=1e-10``; float32 ``rtol=1e-5``.
"""

import io
import warnings

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_torch.models.transformer
import exprgrad_tpu
import exprgrad_tpu.models.transformer
from exprgrad_torch import ScheduleWarning
from exprgrad_torch.io import serialize as port_serialize
from exprgrad_tpu import Fun, compile, input, iters
from exprgrad_tpu.fun import to_program
from exprgrad_tpu.io import serialize as jax_serialize
from test_fuzz import _random_kernel

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


def _port_of_jax_graph(graph, dtype="float64") -> egt.Model:
    """The port model of a graph built with the JAX package's front end:
    its program goes through the checkpoint program format."""
    buf = io.BytesIO()
    jax_serialize.write_program(jax_serialize.Writer(buf),
                                to_program(graph, schedule_scope="cpu"))
    buf.seek(0)
    source = port_serialize.read_program(port_serialize.Reader(buf))
    source.scalar_type = egt.ir.ScalarType(dtype)
    return egt.Model(source, device="cpu")


def _three_ways(family, dtype="float64", name="out"):
    port_graph, args = FAMILIES[family](egt)
    ref_graph, _ = FAMILIES[family](exprgrad_tpu)
    if dtype == "float32":
        args = {k: v.astype(np.float32) for k, v in args.items()}
    port = egt.compile(port_graph.target(name), dtype=dtype, device="cpu")
    got = port.call(name, args)
    for backend in ("jax", "interp"):
        want = compile(ref_graph.target(name), dtype=dtype,
                       backend=backend).call(name, args)
        np.testing.assert_allclose(got, want,
                                   **(F64 if dtype == "float64" else F32))
    return port


def _matmul(m):
    y, x, it = m.iters("y", "x", "it")
    out = m.Fun("out")
    out[y, x] = m.input("a")[y, it] * m.input("b")[it, x] * 0.5
    rng = np.random.default_rng(0)
    return out, {"a": rng.standard_normal((5, 7)),
                 "b": rng.standard_normal((7, 3))}


def _batched_broadcast(m):
    # per-head projection (the attention layer's "ntc,hcd->nhtd") with a
    # write axis no read covers, then a transposed read
    n, h, t, c, d = m.iters("n", "h", "t", "c", "d")
    proj = m.Fun("proj")
    proj[n, h, t, d] = m.input("x")[n, t, c] * m.input("w")[h, c, d]
    n, h, t, d = m.iters("n", "h", "t", "d")
    out = m.Fun("out")
    out[n, h, t, d] = proj[n, h, t, d] * m.input("g")[d, h] - proj[n, h, t, d]
    rng = np.random.default_rng(1)
    return out, {"x": rng.standard_normal((2, 4, 3)),
                 "w": rng.standard_normal((2, 3, 5)),
                 "g": rng.standard_normal((5, 2))}


def _direct_reduce(m):
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(m.input("a")[y, x] * 0.3) / (m.input("a")[y, x] ** 2 + 1.0)
    return out, {"a": np.random.default_rng(2).standard_normal((6, 9))}


def _raw_elementwise(m):
    it = m.iters("it")
    out = m.Fun("out")
    a = m.input("a")
    out.raw[it] = m.select(a.raw[it] >= 0.0, a.raw[it], a.raw[it] * 0.1)
    out.copy_shape(a)
    return out, {"a": np.random.default_rng(3).standard_normal((4, 5))}


def _strided_write(m):
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    a = m.input("a")
    out[2 * y + 1, x] = a[y, x]
    out.with_shape([a.shape[0] * 2 + 1, a.shape[1]])
    return out, {"a": np.random.default_rng(4).standard_normal((4, 3))}


def _grouped_write(m):
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    a = m.input("a")
    out[y // 2, x] = a[y, x] * a[y, x]
    out.with_shape([a.shape[0] // 2, a.shape[1]])
    return out, {"a": np.random.default_rng(5).standard_normal((8, 3))}


def _pool_read(m):
    # separable reads: strided 2*y+dy and grouped y // 2
    y, x = m.iters("y", "x")
    dy = m.irange("dy", 0, 2)
    a = m.input("a")
    out = m.Fun("out")
    out[y, x] = a[2 * y + dy, x] + m.input("b")[y // 2, x]
    out.with_shape([a.shape[0] // 2, a.shape[1]])
    rng = np.random.default_rng(6)
    return out, {"a": rng.standard_normal((8, 3)),
                 "b": rng.standard_normal((2, 3))}


def _embedding_gather(m):
    n, t, d = m.iters("n", "t", "d")
    x = m.Fun("out")
    x[n, t, d] = m.input("emb")[m.to_index(m.input("tok")[n, t]), d]
    n, d = m.iters("n", "d")
    t = m.irange("t", 0, m.input("tok").shape[1])
    x[n, t, d] = m.input("pos")[t, d]
    x.with_shape([m.input("tok").shape[0], m.input("tok").shape[1],
                  m.input("emb").shape[1]])
    rng = np.random.default_rng(7)
    return x, {"emb": rng.standard_normal((11, 4)),
               "pos": rng.standard_normal((16, 4)),
               "tok": rng.integers(0, 11, (3, 5)).astype(np.float64)}


def _bounded_shift(m):
    a = m.input("a")
    y = m.irange("y", 0, a.shape[0] - 1)
    out = m.Fun("out")
    out[y] = a[y + 1] - a[y]
    out.with_shape([a.shape[0] - 1])
    return out, {"a": np.random.default_rng(8).standard_normal(9)}


def _triangular_sum(m):
    a = m.input("a")
    y = m.irange("y", 0, a.shape[0])
    x = m.irange("x", 0, y + 1)
    out = m.Fun("out")
    out[y] = a[y, x] * a[x, y]
    out.with_shape([a.shape[0]])
    return out, {"a": np.random.default_rng(9).standard_normal((6, 6))}


def _triangular_max(m):
    a = m.input("a")
    y = m.irange("y", 0, a.shape[0])
    x = m.irange("x", y, a.shape[1])
    out = m.Fun("out")
    out.maximize[y] = a[y, x]
    out.with_shape([a.shape[0]])
    return out, {"a": np.random.default_rng(10).standard_normal((5, 7))}


def _softmax(m):
    n, t, v = m.iters("n", "t", "v")
    logits = m.Fun("logits")
    logits[n, t, v] = m.input("a")[n, t, v] * 3.0
    out = m.models.transformer._softmax_last(logits)
    out.name = "out"
    return out, {"a": np.random.default_rng(11).standard_normal((2, 3, 7))}


def _trunc_div_mod(m):
    i = m.irange("i", 0, 15)
    a = m.input("a")
    out = m.Fun("out")
    out[i] = (m.to_scalar((i - 7) // 3) * 100.0 + m.to_scalar((i - 7) % 3) * 10.0
              + m.to_scalar(m.wrap(i - 7, 3)) + a[i] * 0.0)
    out.with_shape([15])
    return out, {"a": np.zeros(15)}


def _negative_index_read(m):
    # (i - 6) // 4 is -1 for i in 1..5: a negative index wraps
    i = m.irange("i", 0, 12)
    a = m.input("a")
    out = m.Fun("out")
    out[i] = a[(i - 6) // 4 + 1] + a[(i - 6) % 4 + 3]
    out.with_shape([12])
    return out, {"a": np.random.default_rng(12).standard_normal(7)}


def _scatter_add(m):
    i = m.iters("i")
    out = m.Fun("out")
    out[m.to_index(m.input("idx")[i])] = m.input("vals")[i]
    out.with_shape([6])
    rng = np.random.default_rng(13)
    return out, {"idx": rng.integers(0, 6, 20).astype(np.float64),
                 "vals": rng.standard_normal(20)}


def _scatter_max(m):
    i = m.iters("i")
    out = m.Fun("out")
    out.maximize[m.to_index(m.input("idx")[i])] = m.input("vals")[i]
    out.with_shape([5])
    rng = np.random.default_rng(14)
    return out, {"idx": np.arange(20.0) % 5,
                 "vals": rng.standard_normal(20)}


def _select_max(m):
    y, x = m.iters("y", "x")
    a, b = m.input("a"), m.input("b")
    out = m.Fun("out")
    out[y, x] = m.select(a[y, x] < b[y, x], m.maximum(a[y, x], 0.0),
                       b[y, x] * m.to_scalar(x))
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
    _three_ways(family)


@pytest.mark.parametrize("family", ["matmul", "batched_broadcast",
                                    "embedding_gather", "softmax",
                                    "triangular_max", "scatter_add"])
def test_family_float32(family):
    _three_ways(family, dtype="float32")


def test_trunc_div_mod_values():
    """Nim semantics: -7 // 3 == -2 and -7 % 3 == -1 (truncated), while
    wrap(-7, 3) == 2 (floored)."""
    graph, args = _trunc_div_mod(egt)
    got = egt.compile(graph.target("out"), dtype="float64",
                      device="cpu").call("out", args)
    i = np.arange(15) - 7
    q = np.trunc(i / 3)
    want = q * 100 + (i - q * 3) * 10 + np.mod(i, 3)
    np.testing.assert_array_equal(got, want)


def test_lowering_paths_match_jax_package():
    graph, args = FAMILIES["embedding_gather"](egt)
    port = egt.compile(graph.target("out"), dtype="float64", device="cpu")
    port.call("out", args)
    graph, _ = FAMILIES["embedding_gather"](exprgrad_tpu)
    ref = compile(graph.target("out"), dtype="float64", backend="jax")
    ref.call("out", args)
    assert port.lowering_stats("out") == ref.lowering_stats("out")


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_forward_matches_interp(seed):
    rng = np.random.default_rng(seed)
    graph, arrays = _random_kernel(rng, smooth=False)
    target = graph.target("out")
    got = _port_of_jax_graph(target).call("out", arrays)
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
    got = _port_of_jax_graph(target).call("grad", arrays)
    want = compile(target, dtype="float64", backend="interp").call(
        "grad", arrays)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def test_xor_training_matches_both_backends():
    """20 SGD steps through apply("train"): updated parameters swap back
    into the model after every step, as in the JAX package."""
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float64)
    y = np.array([[0], [1], [1], [0]], np.float64)
    graph = egt.models.xor_mlp(rate=0.5)
    port = egt.compile(graph, dtype="float64", seed=0, device="cpu")
    refs = [compile(exprgrad_tpu.models.xor_mlp(rate=0.5), dtype="float64",
                    seed=0, backend=b)
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
    port = egt.compile(egt.models.xor_mlp(rate=0.5), dtype="float64",
                       seed=1, device="cpu")
    ref = compile(exprgrad_tpu.models.xor_mlp(rate=0.5), dtype="float64",
                  seed=1, backend="interp")
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


def _scheduled_matmul(m):
    y, x, it = m.iters("y", "x", "it")
    out = m.Fun("out")
    out[y, x] = m.input("a")[y, it] * m.param([4, 8])[it, x]
    out.schedule(tile={"y": 8, "x": 8})
    return out.target("out")


def test_schedule_falls_back_with_warning():
    """A float64 model keeps the exact einsum path for a scheduled
    contraction in every mode, as the JAX package does; a float32 one
    runs the kernel (its plain version here).  Under "force", a scheduled
    non-contraction runs the generated map/reduce kernel (B5, stat
    ``mapreduce``) where the JAX package runs ``pallas-mapreduce``."""
    target = _scheduled_matmul(egt)
    a = np.random.default_rng(0).standard_normal((8, 4))
    port = egt.compile(target, dtype="float64", seed=0, device="cpu")
    with pytest.warns(ScheduleWarning, match="float64"):
        got = port.call("out", {"a": a})
    assert port.lowering_stats("out") == {"einsum": 1,
                                          "schedule-fallback": 1}
    want = compile(_scheduled_matmul(exprgrad_tpu), dtype="float64", seed=0,
                   backend="interp").call("out", {"a": a})
    np.testing.assert_allclose(got, want, **F64)

    quiet = egt.compile(target, dtype="float64", seed=0, device="cpu",
                        schedule_mode="ignore")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.call("out", {"a": a})
    forced = egt.compile(target, dtype="float64", seed=0, device="cpu",
                         schedule_mode="force")
    with pytest.warns(ScheduleWarning, match="float64"):
        forced.call("out", {"a": a})
    f32 = egt.compile(target, seed=0, device="cpu", schedule_mode="force")
    f32.call("out", {"a": a.astype(np.float32)})
    assert f32.lowering_stats("out") == {"matmul": 1}

    def rowsum(m):
        y, x = m.iters("y", "x")
        out = m.Fun("out")
        out[y] = m.exp(m.input("a")[y, x])
        out.schedule(tile={"y": 8})
        return out.target("out")

    a32 = {"a": a.astype(np.float32)}
    forced = egt.compile(rowsum(egt), device="cpu", schedule_mode="force")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = forced.call("out", a32)
    assert forced.lowering_stats("out") == {"mapreduce": 1}
    ref = compile(rowsum(exprgrad_tpu), backend="jax", schedule_mode="force")
    np.testing.assert_allclose(got, ref.call("out", a32), **F32)
    assert ref.lowering_stats("out") == {"pallas-mapreduce": 1}


def test_jax_only_methods_raise():
    """No model extra of the JAX package raises in the port any more:
    ``autotune``, the last, returns a ``TuneReport`` and installs its
    schedule (tests/test_torch_autotune.py holds it against the JAX
    package); export, save_hlo and profile are held by
    tests/test_torch_export.py."""
    port = egt.compile(_scheduled_matmul(egt), device="cpu", seed=0)
    a = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    want = port.call("out", {"a": a})
    report = port.autotune("out", {"a": a}, tile_sizes=(64,), reps=1,
                           chain=1)
    assert isinstance(report, egt.TuneReport)
    assert [e.writes for e in report.entries] == ["out"]
    assert port.schedule_mode == "force" and not port._executors
    np.testing.assert_allclose(port.call("out", {"a": a}), want, **F32)


def test_astype_executable_and_precision():
    graph, args = _matmul(egt)
    target = graph.target("out")
    port = egt.compile(target, dtype="float64", device="cpu")
    f32 = port.astype("float32")
    assert f32.call("out", args).dtype == np.float32
    fn = port.executable("out", {n: a.shape for n, a in args.items()})
    np.testing.assert_allclose(fn(args).numpy(), port.call("out", args),
                               **F64)
    with pytest.raises(ValueError, match="precision"):
        egt.compile(target, device="cpu", precision="fastest")
