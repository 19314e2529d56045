"""Port parity: the convolution path (exprgrad_torch/backend/convmatch.py).

A kernel whose two reads are indexed by affine sums of loop iterators is a
convolution; the port runs it as one ``torch.nn.functional.conv1d/2d/3d``
where the JAX package calls ``lax.conv_general_dilated``.  Each family is
built with either package's front end and runs three ways: the port on the
CPU, the JAX package (``backend="jax"``) and the numpy interpreter
(``backend="interp"``), forward and both derived gradients, with the
``conv`` lowering counts equal to the JAX package's.  The families are
those of tests/test_dnn.py and tests/test_backend.py: stride, dilation,
groups (depthwise and general), the image gradient's scatter case, the
filter gradient (run as a weight gradient), rectangular kernels, 1-D
and 3-D.  A convolution over four spatial dims,
which torch has no op for, declines with its reason.  The north-star
workloads (xor_mlp, xor_from_scratch, derivative, fashion_mnist_cnn) run
predict and two ``fit`` steps three ways.
Tolerances: float64 ``rtol=1e-10``; float32 ``rtol=1e-5``.
"""

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_torch.layers
import exprgrad_torch.models
import exprgrad_tpu
import exprgrad_tpu.layers
import exprgrad_tpu.models
from exprgrad_torch import ScheduleWarning

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


def _conv2_layer(m, rng):
    img, flt = m.input("images"), m.input("flt")
    return m.layers.conv2(img, flt), {
        "images": rng.normal(size=(2, 7, 8, 3)),
        "flt": rng.normal(size=(4, 3, 3, 3))}


def _rect(m, rng):
    # a 3x2 kernel over a rectangular image, scaled by a constant
    n, y, x, f, dy, dx, c = m.iters("n", "y", "x", "f", "dy", "dx", "c")
    out = m.Fun("out")
    out[n, y, x, f] = (m.input("images")[n, y + dy, x + dx, c]
                       * m.input("flt")[f, dy, dx, c] * -0.5)
    return out, {"images": rng.normal(size=(2, 6, 9, 2)),
                 "flt": rng.normal(size=(3, 3, 2, 2))}


def _strided(m, rng):
    n, y, x, f, dy, dx, c = m.iters("n", "y", "x", "f", "dy", "dx", "c")
    out = m.Fun("out")
    out[n, y, x, f] = (m.input("images")[n, 2 * y + dy, 2 * x + dx, c]
                       * m.input("flt")[f, dy, dx, c])
    return out, {"images": rng.normal(size=(2, 9, 11, 3)),
                 "flt": rng.normal(size=(4, 3, 3, 3))}


def _dilated_1d(m, rng):
    n, y, f, dy, c = m.iters("n", "y", "f", "dy", "c")
    out = m.Fun("out")
    out[n, y, f] = m.input("images")[n, y + 2 * dy, c] * m.input("flt")[f, dy, c]
    return out, {"images": rng.normal(size=(2, 11, 3)),
                 "flt": rng.normal(size=(4, 3, 3))}


def _depthwise(m, rng):
    img, flt = m.input("images"), m.input("flt")
    return m.layers.depthwise_conv2(img, flt), {
        "images": rng.normal(size=(2, 8, 8, 3)),
        "flt": rng.normal(size=(3, 3, 3))}


def _strided_depthwise(m, rng):
    n, y, x, c, dy, dx = m.iters("n", "y", "x", "c", "dy", "dx")
    out = m.Fun("out")
    out[n, y, x, c] = (m.input("images")[n, 2 * y + dy, 2 * x + dx, c]
                       * m.input("flt")[dy, dx, c])
    return out, {"images": rng.normal(size=(2, 9, 9, 3)),
                 "flt": rng.normal(size=(3, 3, 3))}


def _grouped(m, rng):
    n, y, x, g, c, f, dy, dx = m.iters("n", "y", "x", "g", "c", "f", "dy",
                                       "dx")
    out = m.Fun("out")
    out[n, y, x, g, f] = (m.input("images")[n, y + dy, x + dx, g, c]
                          * m.input("flt")[g, dy, dx, c, f])
    return out, {"images": rng.normal(size=(2, 6, 6, 2, 3)),
                 "flt": rng.normal(size=(2, 3, 3, 3, 4))}


def _conv3d(m, rng):
    n, z, y, x, f, dz, dy, dx, c = m.iters("n", "z", "y", "x", "f", "dz",
                                           "dy", "dx", "c")
    out = m.Fun("out")
    out[n, z, y, x, f] = (m.input("images")[n, z + dz, y + dy, x + dx, c]
                          * m.input("flt")[f, dz, dy, dx, c])
    return out, {"images": rng.normal(size=(2, 5, 6, 5, 2)),
                 "flt": rng.normal(size=(3, 2, 3, 2, 2))}


def _conv4d(m, rng):
    n, a, y, x, w, f, da, dy, dx, dw, c = m.iters(
        "n", "a", "y", "x", "w", "f", "da", "dy", "dx", "dw", "c")
    out = m.Fun("out")
    out[n, a, y, x, w, f] = (
        m.input("images")[n, a + da, y + dy, x + dx, w + dw, c]
        * m.input("flt")[f, da, dy, dx, dw, c])
    return out, {"images": rng.normal(size=(1, 3, 4, 3, 4, 2)),
                 "flt": rng.normal(size=(2, 2, 2, 2, 2, 2))}


FAMILIES = {
    "conv2_layer": _conv2_layer,
    "rectangular_scaled": _rect,
    "strided": _strided,
    "dilated_1d": _dilated_1d,
    "depthwise": _depthwise,
    "strided_depthwise": _strided_depthwise,
    "grouped": _grouped,
    "conv3d": _conv3d,
}


def _graph(m, family):
    """Targets "out", and the gradients of sum(out^2) as "dimages" and
    "dflt"; the inputs, from a numpy seed."""
    out, args = family(m, np.random.default_rng(0))
    it = m.iters("it")
    targets = [out.target("out")]
    for name in ("images", "flt"):
        loss = m.Fun(f"loss_{name}")
        loss[0] = m.sq(out.raw[it])
        targets.append(loss.target(f"loss_{name}").backwards()
                       .grad(m.input(name)).target(f"d{name}"))
    return targets, args


def _three_ways(family, dtype):
    """In float32 the three sum in different orders (torch's CPU conv,
    XLA's, numpy's loops), and sums of products of normals cancel: an
    entry is held to 1e-5 of the target's largest magnitude."""
    port_graph, args = _graph(egt, family)
    ref_graph, _ = _graph(exprgrad_tpu, family)
    args = {k: v.astype(dtype) for k, v in args.items()}
    port = egt.compile(port_graph, dtype=dtype, device="cpu")
    refs = [exprgrad_tpu.compile(ref_graph, dtype=dtype, backend=b)
            for b in ("jax", "interp")]
    for target in ("out", "dimages", "dflt"):
        got = port.call(target, args)
        for ref in refs:
            want = ref.call(target, args)
            tol = (F64 if dtype == "float64" else
                   dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max())))
            np.testing.assert_allclose(got, want, **tol)
    return port, refs[0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_conv_family_matches_both_backends(family):
    port, ref = _three_ways(FAMILIES[family], "float64")
    for target in ("out", "dimages", "dflt"):
        got, want = port.lowering_stats(target), ref.lowering_stats(target)
        assert got.get("conv", 0) == want.get("conv", 0) >= 1, (target, got)
        assert got == {k: v for k, v in want.items()
                       if not k.startswith("pallas")}, (target, got, want)


@pytest.mark.parametrize("family", ["conv2_layer", "grouped", "strided"])
def test_conv_family_float32(family):
    _three_ways(FAMILIES[family], "float32")


def test_image_gradient_is_a_flipped_conv_not_a_scatter():
    port, _ = _three_ways(FAMILIES["conv2_layer"], "float64")
    stats = port.lowering_stats("dimages")
    # the forward again, then the image gradient
    assert stats.get("conv") == 2 and "general-scatter" not in stats, stats
    cases = sorted(m.case for m in _conv_matches(port, "dimages"))
    assert cases == ["scatter", "window"], cases


def _conv_matches(port, target):
    (executor,) = [e for (name, _), e in port._executors.items()
                   if name == target]
    return [low._conv for low in executor._lowerings.values()
            if low._conv is not None and low._conv.ok]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_filter_gradient_runs_as_a_weight_gradient(family):
    """A filter gradient (a window whose kernel, the output gradient,
    spans more points than its output) runs as torch.nn.grad's weight
    gradient; forwards and image gradients as convolutions."""
    port, _ = _three_ways(FAMILIES[family], "float64")
    assert [m.filter_gradient for m in _conv_matches(port, "out")] == [False]
    routes = sorted(m.filter_gradient for m in _conv_matches(port, "dflt"))
    assert routes == [False, True], routes  # the forward again, then dflt


def test_four_spatial_dims_decline_with_reason():
    """torch has conv1d to conv3d: a match over four spatial dims takes
    the general path, warns and counts a fallback; the JAX package's lax
    conv takes it.  The values agree all the same."""
    port_graph, args = _graph(egt, _conv4d)
    ref_graph, _ = _graph(exprgrad_tpu, _conv4d)
    port = egt.compile(port_graph[0], dtype="float64", device="cpu")
    with pytest.warns(ScheduleWarning, match="4 spatial dims"):
        got = port.call("out", args)
    stats = port.lowering_stats("out")
    assert "conv" not in stats and stats["schedule-fallback"] == 1, stats
    refs = [exprgrad_tpu.compile(ref_graph[0], dtype="float64", backend=b)
            for b in ("jax", "interp")]
    for ref in refs:
        np.testing.assert_allclose(got, ref.call("out", args), **F64)
    assert refs[0].lowering_stats("out") == {"conv": 1}


# --- the north-star workloads -------------------------------------------

XOR_X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]] * 2, np.float32)
XOR_Y = np.array([[0], [1], [1], [0]] * 2, np.float32)


def _derivative(m):
    x = m.input("x")
    it = m.iters("it")
    y = m.Fun("y")
    y[it] = x[it] * x[it]
    return y.target("y").backwards().grad(x).target("grad_x")


def _cnn_data(n=8):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return {"x": x, "y": y}


WORKLOADS = {
    # name: (graph of a package, fit target, data, predict target)
    "xor_mlp": (lambda m: m.models.xor_mlp(rate=0.1), "train",
                {"x": XOR_X, "y": XOR_Y}, "predict"),
    "xor_from_scratch": (lambda m: m.models.xor_from_scratch(rate=0.1),
                         "train", {"x": XOR_X, "y": XOR_Y}, "predict"),
    "fashion_mnist_cnn": (lambda m: m.models.fashion_mnist_cnn(), "fit",
                          _cnn_data(), "predict"),
}


def _fit_twice(name, dtype, backends):
    """Predict, then two ``fit`` batches (one epoch), from the same seed;
    returns the port and the JAX package's models."""
    build, fit_target, data, predict = WORKLOADS[name]
    data = {k: v.astype(dtype) for k, v in data.items()}
    port = egt.compile(build(egt), dtype=dtype, seed=10, device="cpu")
    refs = [exprgrad_tpu.compile(build(exprgrad_tpu), dtype=dtype, seed=10,
                                 backend=b) for b in backends]
    tol = F64 if dtype == "float64" else F32
    pred_args = {"x": data["x"]}
    batch = len(data["x"]) // 2
    for ref in refs:
        np.testing.assert_allclose(port.call(predict, pred_args),
                                   ref.call(predict, pred_args), **tol)
    for m in (port, *refs):
        m.fit(fit_target, data, batch_size=batch, log_status=False)
    for ref in refs:
        for tid, value in ref.params.items():
            np.testing.assert_allclose(port.params[tid].numpy(),
                                       np.asarray(value), **tol)
        for tid, value in ref.caches.items():
            np.testing.assert_allclose(port.caches[tid].numpy(),
                                       np.asarray(value), **tol)
        np.testing.assert_allclose(port.call(predict, pred_args),
                                   ref.call(predict, pred_args), **tol)
    return port, refs


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_north_star_workload_three_ways(name):
    """float64: the port on the CPU against ``backend="jax"`` and
    ``"interp"``, with the ``conv`` counts of the JAX package."""
    port, (ref, _) = _fit_twice(name, "float64", ("jax", "interp"))
    fit_target = WORKLOADS[name][1]
    got = port.lowering_stats(fit_target)
    want = ref.lowering_stats(fit_target)
    assert got.get("conv", 0) == want.get("conv", 0), (got, want)
    if name == "fashion_mnist_cnn":
        # the JAX package's own expectation (tests/test_train_oracle.py)
        assert got["conv"] >= 5 and "general-scatter" not in got, got


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_north_star_workload_float32(name):
    """float32 against ``backend="jax"``.  (The numpy interpreter sums
    float32 in its own order; after adam it sits 1.8e-6 from the JAX
    package on fashion_mnist_cnn's dense weights, and it is held in
    float64 above.)"""
    _fit_twice(name, "float32", ("jax",))


def test_derivative_three_ways():
    xs = np.linspace(-2, 2, 9).astype(np.float32)
    port = egt.compile(_derivative(egt), device="cpu")
    for backend in ("jax", "interp"):
        ref = exprgrad_tpu.compile(_derivative(exprgrad_tpu),
                                   backend=backend)
        for target in ("y", "grad_x"):
            np.testing.assert_allclose(port.call(target, {"x": xs}),
                                       ref.call(target, {"x": xs}), **F32)
    np.testing.assert_allclose(port.call("grad_x", {"x": xs}), 2 * xs,
                               **F32)
