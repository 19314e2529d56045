"""Port parity: the MoE and recurrent extern ops (exprgrad_torch/ops/moe.py,
exprgrad_torch/ops/recurrent.py).

Each op runs inside a DSL program built with either package's front end:
its output, the input gradient its ``_grad`` op gives, and the parameters
after two gradient-descent steps (every parameter gradient).  float32 is
held against ``backend="jax"`` (``jax.vjp`` of the JAX implementation,
which computes in float32) at ``rtol=1e-5``, float64 against
``backend="interp"`` (the numpy oracle with its hand-derived backward,
which computes in float64) at ``rtol=1e-10``; the port computes a float64
program in float64.  A tied routing case pins ``jax.lax.top_k``'s rule
(ties go to the lowest expert).  The models that carry the ops,
``flash_transformer(moe_experts=4)`` and ``tiny_recurrent_lm`` with each
cell, train two ``fit`` steps from the JAX model's state carried over by
``from_state``.
"""

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers
import exprgrad_torch.models
import exprgrad_tpu
import exprgrad_tpu.layers
import exprgrad_tpu.models
from exprgrad_torch.ops import moe as port_moe

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)
DIM, HID = 6, 10


def _moe(k):
    return lambda m, x: m.layers.moe_ffn(x, DIM, HID, n_experts=4, k=k)


def _cell(name):
    return lambda m, x: getattr(m.layers, name)(x, DIM, HID, init=0.3)


OPS = {
    "moe_k1": _moe(1),
    "moe_k2": _moe(2),
    "lstm": _cell("lstm"),
    "gru": _cell("gru"),
    "rnn_tanh": _cell("rnn_tanh"),
}


def _graph(m, op):
    """Targets "y" (the op), "dx" (the gradient of mean((y - t)^2) by x)
    and "train" (gradient descent on every parameter of the op)."""
    x, t = m.input("x"), m.input("t")
    y = OPS[op](m, x)
    targets = [y.target("y")]
    for name in ("loss_x", "loss"):
        i, j, k = m.iters("i", "j", "k")
        loss = m.Fun(name)
        loss[0] = (y[i, j, k] - t[i, j, k]) ** 2 / m.to_scalar(
            x.shape[0] * x.shape[1])
        targets.append(loss.target(name))
    targets[1] = targets[1].backwards().grad(x).target("dx")
    targets[2] = targets[2].backwards().optimize(
        m.make_opt(m.layers.gradient_descent, rate=0.5)).target("train")
    return targets


def _args(op, dtype, rng):
    width = DIM if op.startswith("moe") else HID
    return {"x": rng.normal(size=(2, 7, DIM)).astype(dtype),
            "t": rng.normal(size=(2, 7, width)).astype(dtype)}


def _check(op, dtype, backend, args=None, gate=None):
    tol = F64 if dtype == "float64" else F32
    ref = exprgrad_tpu.compile(_graph(exprgrad_tpu, op), dtype=dtype,
                               seed=3, backend=backend)
    if gate is not None:
        (tid,) = [t for t in ref.params
                  if ref.program.tensors[t].name == "moe.gate"]
        ref.params[tid] = gate.astype(dtype)
    port = egt.from_state(_graph(egt, op), ref.params, ref.caches,
                          dtype=dtype, device="cpu")
    if args is None:
        args = _args(op, dtype, np.random.default_rng(0))
    for target in ("y", "dx"):
        np.testing.assert_allclose(port.call(target, args),
                                   ref.call(target, args), **tol)
    for _ in range(2):
        for m in (port, ref):
            m.apply("train", args)
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(),
                                   np.asarray(value), **tol)
    name = "moe" if op.startswith("moe") else op
    stats = port.lowering_stats("train")
    assert stats[f"extern:{name}"] == 1 and stats[f"extern:{name}_grad"] >= 1
    return port


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_float32_matches_jax(op):
    _check(op, "float32", "jax")


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_float64_matches_interp(op):
    _check(op, "float64", "interp")


@pytest.mark.parametrize("dtype,backend", [("float32", "jax"),
                                           ("float64", "interp")])
def test_tied_routing_picks_the_lowest_experts(dtype, backend):
    """Experts 1 and 2 share a gate column, so every token ties between
    them: where the pair ranks first, k=2 takes both, 1 first; elsewhere
    it takes 1 and never 2.  Four equal probabilities take 0 and 1."""
    rng = np.random.default_rng(1)
    gate = rng.normal(size=(DIM, 4)) * 0.3
    gate[:, 2] = gate[:, 1]
    args = _args("moe_k2", dtype, rng)
    _check("moe_k2", dtype, backend, args=args, gate=gate)
    x = torch.from_numpy(args["x"])
    _, idx, _, _ = port_moe.routing(x, torch.from_numpy(
        gate.astype(dtype)), 2)
    # expert 2 is chosen only as the second of the tied pair, after 1
    assert (idx[..., 0] != 2).all()
    assert ((idx[..., 1] != 2) | (idx[..., 0] == 1)).all()
    assert (idx[..., 1] == 2).any() and (idx[..., 0] == 1).any()
    # all four equal: experts 0 and 1, in that order
    _, idx, weight, _ = port_moe.routing(x, torch.zeros(DIM, 4, dtype=x.dtype),
                                         2)
    assert (idx == torch.tensor([0, 1])).all()
    assert torch.equal(weight, torch.full_like(weight, 0.5))


def _lm_args(vocab, seq, rng):
    toks = rng.integers(0, vocab, (4, seq))
    return {"tokens": toks.astype(np.float32),
            "labels": np.eye(vocab, dtype=np.float32)[(toks + 1) % vocab]}


MODELS = {
    "flash_transformer_moe": (
        lambda m: m.models.flash_transformer(
            vocab=8, dim=16, heads=2, hidden=32, max_seq=16, moe_experts=4,
            moe_k=2), 8, 16, "moe"),
    "tiny_recurrent_lm_lstm": (
        lambda m: m.models.tiny_recurrent_lm(cell="lstm"), 16, 8, "lstm"),
    "tiny_recurrent_lm_gru": (
        lambda m: m.models.tiny_recurrent_lm(cell="gru"), 16, 8, "gru"),
    "tiny_recurrent_lm_rnn": (
        lambda m: m.models.tiny_recurrent_lm(cell="rnn"), 16, 8,
        "rnn_tanh"),
}


def assert_trained_alike(port, ref, before, rtol=1e-5):
    """Port and JAX models after the same adam steps from the same state
    (``before``: the parameters as numpy arrays).  Caches agree entry by
    entry at F32.  Adam divides each entry's step by its running gradient
    magnitude, so an entry whose gradient is near adam's eps moves with
    the float32 summation order (ROADMAP.md queue C); each parameter's
    update is held in L2 norm: ``|dport - dref| <= rtol |dref|``."""
    for tid, value in ref.caches.items():
        np.testing.assert_allclose(port.caches[tid].numpy(),
                                   np.asarray(value), **F32)
    for tid, value in ref.params.items():
        want = np.asarray(value, np.float64) - before[tid]
        got = port.params[tid].numpy().astype(np.float64) - before[tid]
        err = np.linalg.norm(got - want)
        assert err <= rtol * np.linalg.norm(want), (
            port.program.tensors[tid].name, err, np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_trains_like_jax(name):
    """Predict, then one ``fit`` epoch of two adam batches, from the JAX
    model's state; adam caches, parameter updates and the loss agree."""
    build, vocab, seq, op = MODELS[name]
    ref = exprgrad_tpu.compile(build(exprgrad_tpu), backend="jax", seed=0)
    port = egt.from_state(build(egt), ref.params, ref.caches, ref.epoch,
                          ref._rng.bit_generator.state, device="cpu")
    before = {t: np.asarray(v, np.float64) for t, v in ref.params.items()}
    args = _lm_args(vocab, seq, np.random.default_rng(0))
    pred = {"tokens": args["tokens"]}
    np.testing.assert_allclose(port.call("predict", pred),
                               ref.call("predict", pred), **F32)
    for m in (port, ref):
        m.fit("train", args, batch_size=2, log_status=False)
    assert_trained_alike(port, ref, before)
    np.testing.assert_allclose(port.call("loss", args),
                               ref.call("loss", args), **F32)
    stats = port.lowering_stats("train")
    assert stats[f"extern:{op}"] == 1 and stats[f"extern:{op}_grad"] >= 1
