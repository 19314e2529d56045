"""Port parity: the model zoo trains like the JAX package.

Each model of the zoo is built with its function's default widths in either
package's front end; the port starts from the JAX model's state
(``from_state``), runs its prediction target, then two ``fit`` batches
(one epoch) of its training target, beside ``backend="jax"`` on the same
numpy inputs.  In float32, predictions and the loss before and after
training agree at ``rtol=1e-5``; in float64 so do every parameter and
adam cache entry, at ``rtol=1e-10``.  Inverse rendering
(``models/render.py`` at tests/test_render.py's size) trains two
gradient-descent steps through ``apply``: its scene inputs have no batch
dimension to ``fit`` over.
"""

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_torch.layers
import exprgrad_torch.models
import exprgrad_torch.models.render
import exprgrad_tpu
import exprgrad_tpu.layers
import exprgrad_tpu.models
import exprgrad_tpu.models.render
from test_torch_externs import F32, F64


def _onehot(rng, n, classes):
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _seq2seq_data(rng):
    src = rng.integers(1, 8, (4, 6))
    tgt = np.concatenate([np.zeros((4, 1), int), src[:, ::-1][:, :-1]], 1)
    return {"src": src.astype(np.float32), "tgt": tgt.astype(np.float32),
            "labels": np.eye(8, dtype=np.float32)[src[:, ::-1]]}


def _lm_data(rng):
    toks = rng.integers(0, 8, (4, 8))
    return {"tokens": toks.astype(np.float32),
            "labels": np.eye(8, dtype=np.float32)[(toks + 1) % 8]}


def _diffusion_data(rng):
    abar = exprgrad_tpu.models.ddpm_schedule()[2]
    return exprgrad_tpu.models.diffusion_train_batch(
        _normal(rng, 4, 2), abar, rng)


# name: (graph of a package, data from a numpy generator, prediction
# target and its inputs, training target, loss target or None)
ZOO = {
    "tiny_mixer": (
        lambda m: m.models.tiny_mixer(),
        lambda r: {"x": _normal(r, 4, 9, 16), "labels": _onehot(r, 4, 4)},
        "predict", ("x",), "train", "loss"),
    "tiny_vit": (
        lambda m: m.models.tiny_vit(),
        lambda r: {"x": _normal(r, 4, 12, 12), "labels": _onehot(r, 4, 4)},
        "predict", ("x",), "train", "loss"),
    "mobile_cnn": (
        lambda m: m.models.mobile_cnn(),
        lambda r: {"x": _normal(r, 4, 28, 28), "y": _onehot(r, 4, 10)},
        "predict", ("x",), "fit", "loss"),
    "conv_autoencoder": (
        lambda m: m.models.conv_autoencoder(),
        lambda r: {"x": r.random((4, 28, 28)).astype(np.float32)},
        "decode", ("x",), "train", "loss"),
    "mnist_gan_gen": (
        lambda m: m.models.mnist_gan(),
        lambda r: {"seed": _normal(r, 4, 32)},
        "gen", ("seed",), "fit.gen", "loss.gen"),
    "mnist_gan_discr": (
        lambda m: m.models.mnist_gan(),
        lambda r: {"samples": r.random((4, 784)).astype(np.float32),
                   "labels": r.integers(0, 2, (4, 1)).astype(np.float32)},
        "discr", ("samples",), "fit.discr", "loss.discr"),
    "tiny_vae": (
        lambda m: m.models.tiny_vae(),
        lambda r: {"x": _normal(r, 4, 2), "eps": _normal(r, 4, 2)},
        "encode", ("x",), "train", "loss"),
    "tiny_transformer": (
        lambda m: m.models.tiny_transformer(), _lm_data,
        "predict", ("tokens",), "train", None),
    "tiny_seq2seq": (
        lambda m: m.models.tiny_seq2seq(), _seq2seq_data,
        "predict", ("src", "tgt"), "train", "loss"),
    "tiny_diffusion": (
        lambda m: m.models.tiny_diffusion(), _diffusion_data,
        "predict", ("t",), "train", "loss"),
}


def _pair(name, dtype):
    build = ZOO[name][0]
    ref = exprgrad_tpu.compile(build(exprgrad_tpu), dtype=dtype,
                               backend="jax", seed=0)
    port = egt.from_state(build(egt), ref.params, ref.caches, ref.epoch,
                          ref._rng.bit_generator.state, dtype=dtype,
                          device="cpu")
    return port, ref


def _args(name, dtype):
    _, data, predict, pred_inputs, _, _ = ZOO[name]
    args = {k: v.astype(dtype)
            for k, v in data(np.random.default_rng(0)).items()}
    pred = {k: args[k] for k in pred_inputs}
    if name == "tiny_diffusion":  # eps_theta reads x_t and t
        pred = {"xt": args["x0"], "t": args["t"]}
    return args, pred


# both packages keep attention's logsumexp in float32 (ops/attention.py),
# so a float64 model with attention agrees to about 1e-9, not 1e-10
ATTENTION = {"tiny_seq2seq", "tiny_vit"}


def _loss_args(name, port, args):
    if name == "mnist_gan_gen":
        return {"seed": args["seed"]}
    return {k: v for k, v in args.items() if k in port.program.inputs}


@pytest.mark.parametrize("name", sorted(set(ZOO) - ATTENTION))
def test_zoo_model_trains_like_jax(name):
    """float64: predict, two ``fit`` batches, then predict and the loss
    again, every parameter and cache entry at ``rtol=1e-10``."""
    _, _, predict, _, train, loss = ZOO[name]
    port, ref = _pair(name, "float64")
    args, pred = _args(name, "float64")
    np.testing.assert_allclose(port.call(predict, pred),
                               ref.call(predict, pred), **F64)
    for m in (port, ref):
        m.fit(train, args, batch_size=2, log_status=False)
    assert port.epoch == ref.epoch == 1
    for table, ref_table in ((port.params, ref.params),
                             (port.caches, ref.caches)):
        for tid, value in ref_table.items():
            np.testing.assert_allclose(table[tid].numpy(),
                                       np.asarray(value), **F64)
    np.testing.assert_allclose(port.call(predict, pred),
                               ref.call(predict, pred), **F64)
    if loss is not None:
        loss_args = _loss_args(name, port, args)
        np.testing.assert_allclose(port.call(loss, loss_args),
                                   ref.call(loss, loss_args), **F64)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_model_float32(name):
    """float32: predict, one ``fit`` epoch, then predict and the loss
    again at ``rtol=1e-5``.  (Parameters are held per entry in float64
    above: in float32 a parameter's update carries its gradient's float32
    summation error, up to 1.5e-5 of the update in L2 norm here.)"""
    _, _, predict, _, train, loss = ZOO[name]
    port, ref = _pair(name, "float32")
    args, pred = _args(name, "float32")
    np.testing.assert_allclose(port.call(predict, pred),
                               ref.call(predict, pred), **F32)
    for m in (port, ref):
        m.fit(train, args, batch_size=2, log_status=False)
    np.testing.assert_allclose(port.call(predict, pred),
                               ref.call(predict, pred), **F32)
    if loss is not None:
        loss_args = _loss_args(name, port, args)
        np.testing.assert_allclose(port.call(loss, loss_args),
                                   ref.call(loss, loss_args), **F32)


SIZE = 32
SCENE = {
    "camera": np.array([1.0], np.float32),
    "background": np.array([0.5, 0.5, 0.5], np.float32),
    "sphere0.geom": np.array([0.5, 0.2, 4.0, 0.5], np.float32),
    "sphere1.geom": np.array([-0.6, -0.35, 3.0, 0.5], np.float32),
    "light": np.array([1.0, 1.0, -0.5], np.float32),
}


def _render_graph(m):
    render = m.models.render
    scene = render.two_sphere_scene(trainable_colors=True)
    return (render.render(scene, SIZE, SIZE).target("render")
            .pipe(m.layers.mse, m.input("target")).target("loss")
            .backprop(m.make_opt(m.layers.gradient_descent, rate=0.02))
            .target("train"))


def test_inverse_rendering_trains_like_jax():
    ref = exprgrad_tpu.compile(_render_graph(exprgrad_tpu), backend="jax",
                               seed=0)
    port = egt.from_state(_render_graph(egt), ref.params, ref.caches,
                          device="cpu")
    target = np.random.default_rng(0).random((SIZE, SIZE, 3)).astype(
        np.float32)
    args = {**SCENE, "target": target}
    np.testing.assert_allclose(port.call("render", SCENE),
                               ref.call("render", SCENE), **F32)
    for _ in range(2):
        for m in (port, ref):
            m.apply("train", args)
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(),
                                   np.asarray(value), **F32)
    np.testing.assert_allclose(port.call("loss", args),
                               ref.call("loss", args), **F32)
