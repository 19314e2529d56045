"""Port parity: checkpoints, EMA parameters and the training driver
(exprgrad_torch/io, Model.ema_params, exprgrad_torch/train.py).

Checkpoints pass between the two packages in both directions and carry
the state exactly (``assert_array_equal``).  Trained state is compared at
the tolerance of tests/test_torch_transformer.py (``rtol=1e-4,
atol=2e-5``), predictions at ``rtol=1e-4, atol=1e-5``.
"""

import importlib

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_torch.io as egt_io
import exprgrad_torch.layers
import exprgrad_torch.models
import exprgrad_tpu
import exprgrad_tpu.layers
import exprgrad_tpu.models
from exprgrad_torch import ModelRuntimeError
from exprgrad_tpu import compile
from exprgrad_tpu import io as jax_io
from exprgrad_tpu.train import (classification_accuracy, evaluate,
                                train as jax_train)

# the package exports the function ``train``, which shadows the module
egt_train = importlib.import_module("exprgrad_torch.train")

VOCAB = 8
TRAIN_TOL = dict(rtol=1e-4, atol=2e-5)
PREDICT_TOL = dict(rtol=1e-4, atol=1e-5)


def _graph(pkg=egt, opt=None, **kw):
    """The test model, built with ``pkg``'s builders (the port's or the
    JAX package's); ``opt(pkg)`` builds the optimizer."""
    if opt is not None:
        kw["opt"] = opt(pkg)
    return pkg.models.flash_transformer(vocab=VOCAB, dim=16, heads=2,
                                        hidden=16, blocks=1, max_seq=32,
                                        **kw)


def _twins(seed, **kw):
    """A JAX model and the port model built from the same program with
    the port's builders, carrying the JAX model's initial state."""
    ref = compile(_graph(exprgrad_tpu, **kw), backend="jax", seed=seed)
    port = egt.from_state(_graph(egt, **kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          device="cpu")
    return ref, port


def _adam(eta):
    return lambda pkg: pkg.make_opt(pkg.layers.adam, eta=eta)


def _data(seed, n=4, t=12, shift=1):
    """Cyclic sequences; labels are the token ``shift`` ahead."""
    rng = np.random.default_rng(seed)
    toks = (rng.integers(0, VOCAB, n)[:, None] + np.arange(t)) % VOCAB
    labels = np.eye(VOCAB, dtype=np.float32)[(toks + shift) % VOCAB]
    return {"tokens": toks.astype(np.float32), "labels": labels}


def _steps(model, args, n):
    for _ in range(n):
        model.epoch += 1
        model.apply("train", args)


def _assert_state_equal(port, ref):
    assert port.epoch == ref.epoch
    for table, ref_table in ((port.params, ref.params),
                             (port.caches, ref.caches)):
        assert table.keys() == ref_table.keys()
        for tid, value in ref_table.items():
            np.testing.assert_array_equal(np.asarray(table[tid]),
                                          np.asarray(value))


def test_checkpoint_from_port_loads_in_jax(tmp_path):
    port = egt.compile(_graph(), seed=0, device="cpu")
    args = _data(0)
    _steps(port, args, 2)
    path = str(tmp_path / "port.egt")
    egt_io.save_model(port, path)
    ref = jax_io.load_model(path)
    _assert_state_equal(port, ref)
    assert ref._rng.bit_generator.state == port._rng.bit_generator.state
    toks = {"tokens": args["tokens"]}
    np.testing.assert_allclose(ref.call("predict", toks),
                               port.call("predict", toks), **PREDICT_TOL)


def test_checkpoint_from_jax_loads_in_port(tmp_path):
    ref = compile(_graph(exprgrad_tpu, kv_heads=1), backend="jax", seed=1)
    args = _data(1)
    _steps(ref, args, 2)
    path = str(tmp_path / "jax.egt")
    jax_io.save_model(ref, path)
    port = egt_io.load_model(path, device="cpu")
    assert isinstance(port, egt.Model) and port.device.type == "cpu"
    _assert_state_equal(port, ref)
    toks = {"tokens": args["tokens"]}
    np.testing.assert_allclose(port.call("predict", toks),
                               ref.call("predict", toks), **PREDICT_TOL)
    # training resumes where the checkpoint left off
    _steps(ref, args, 1)
    _steps(port, args, 1)
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(),
                                   np.asarray(value), **TRAIN_TOL)


def test_npz_export_and_import_between_packages(tmp_path):
    port = egt.compile(_graph(), seed=2, device="cpu")
    _steps(port, _data(2), 1)
    path = str(tmp_path / "params.npz")
    egt_io.export_params_npz(port, path)
    ref = compile(_graph(exprgrad_tpu), backend="jax", seed=5)
    jax_io.import_params_npz(ref, path)
    ref.epoch = port.epoch
    _assert_state_equal(port, ref)
    # and back: a fresh port model takes the JAX model's export
    jax_io.export_params_npz(ref, path)
    other = egt.compile(_graph(), seed=7, device="cpu")
    egt_io.import_params_npz(other, path)
    other.epoch = ref.epoch
    _assert_state_equal(other, ref)
    assert all(v.dtype == other.dtype for v in other.params.values())


def test_ema_params_match_jax():
    ref, port = _twins(3, opt=lambda pkg: pkg.layers.with_ema(
        _adam(0.01)(pkg), decay=0.9))
    args = _data(3)
    _steps(ref, args, 3)
    _steps(port, args, 3)
    got, want = port.ema_params(), ref.ema_params()
    assert got.keys() == want.keys() == set(ref.params)
    for tid, value in want.items():
        assert got[tid].device == port.device
        np.testing.assert_allclose(got[tid].numpy(), value, **TRAIN_TOL)
    # the caches stay the port's tensors
    assert all(hasattr(v, "device") for v in port.caches.values())
    port.params.update(port.ema_params())
    assert port.call("predict", {"tokens": args["tokens"]}).shape == (
        4, 12, VOCAB)


def test_ema_params_without_shadows_raises():
    port = egt.compile(_graph(), seed=0, device="cpu")
    with pytest.raises(ModelRuntimeError, match="no EMA shadows"):
        port.ema_params()


def test_train_restores_best_state_as_jax_does():
    """Validation labels disagree with training labels, so the validation
    loss turns up after the first epochs, patience stops the run and the
    best epoch's state comes back — the same history and state as the
    JAX package's driver."""
    ref, port = _twins(4, opt=_adam(0.05))
    data, val = _data(4, n=8), _data(5, n=4, shift=2)
    kw = dict(epochs=8, batch_size=4, validation=val, patience=2,
              shuffle=False)
    want = jax_train(ref, "train", data, **kw)
    got = egt_train.train(port, "train", data, **kw)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want]
    assert len(got) < 8  # stopped early
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], **TRAIN_TOL)
    best = min(got, key=lambda e: e["val_loss"])
    assert port.epoch == best["epoch"] < got[-1]["epoch"]
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(),
                                   np.asarray(value), **TRAIN_TOL)


def test_train_scan_batches_and_metrics():
    ref, port = _twins(6)
    data = _data(6, n=8)
    kw = dict(epochs=2, batch_size=4, scan_batches=True, shuffle=False)
    want = jax_train(ref, "train", data, **kw)
    logged = []
    got = egt_train.train(port, "train", data, log=logged.append, **kw)
    assert len(logged) == 2
    for a, b in zip(got, want):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   **TRAIN_TOL)
    np.testing.assert_allclose(egt_train.evaluate(port, "loss", data, 4),
                               evaluate(ref, "loss", data, 4),
                               **TRAIN_TOL)
    np.testing.assert_allclose(
        egt_train.classification_accuracy(port, {"tokens": data["tokens"]},
                                          data["labels"]),
        classification_accuracy(ref, {"tokens": data["tokens"]},
                                          data["labels"]))


@pytest.mark.parametrize("kw,match", [({"mesh": object()}, "A14")])
def test_train_options_not_ported_raise(kw, match):
    port = egt.compile(_graph(), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        egt_train.train(port, "train", _data(0), epochs=1, **kw)


def test_shuffle_order_is_the_native_shuffle():
    """fit(shuffle=True) visits rows in the order of the JAX package's
    native Fisher-Yates shuffle (SplitMix64) for the same seed."""
    from exprgrad_torch.model import shuffle_indices

    assert shuffle_indices(12, 3).tolist() == [3, 10, 8, 5, 2, 4, 1, 11, 0,
                                               7, 6, 9]
    assert sorted(shuffle_indices(1000, 2**31 - 2).tolist()) == list(
        range(1000))
