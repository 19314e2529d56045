"""Port parity: the flash_transformer predict and train targets end to end.

Each program is built twice, with the JAX package's builders and with
the port's; the port model carries the JAX model's state
(``from_state``) and both run "predict" on the same tokens.  Tolerance
``rtol=1e-4, atol=1e-5`` on the next-token probabilities, the bound the
JAX package's serving tests use (tests/test_serve.py).

Training runs the same adam steps on both packages (the JAX package's
flash backward in interpret mode) and compares parameters, optimizer
caches and the loss at ``rtol=1e-4, atol=2e-5``: float32 on both sides,
summed in other orders, and adam divides small gradient entries by their
own magnitude, which carries their rounding into the update (the largest
difference seen in three steps at these widths was 1e-5).
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
from exprgrad_tpu import compile

VOCAB = 16
TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=2e-5)

CONFIGS = {
    "mha": dict(),
    "mqa": dict(kv_heads=1),
    "gqa_window": dict(kv_heads=2, window=8),
    "rope": dict(rope=True),
    "swiglu_tied": dict(ffn="swiglu", tie_embeddings=True, rope=True),
}


def _twins(seed, **kw):
    """``flash_transformer(**kw)`` compiled by the JAX package and the
    same program built with the port's builder, carrying the JAX model's
    state.  ``kw["opt"]``, when given, builds the optimizer from a
    package."""
    opt = kw.pop("opt", None)

    def graph(pkg):
        extra = {} if opt is None else {"opt": opt(pkg)}
        return pkg.models.flash_transformer(**kw, **extra)

    ref = compile(graph(exprgrad_tpu), backend="jax", seed=seed)
    return ref, _port_of(ref, graph(egt))


def _port_of(ref, graph):
    return egt.from_state(graph, ref.params, ref.caches, ref.epoch,
                          ref._rng.bit_generator.state, device="cpu")


def _tokens(seed, n=2, t=48):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (n, t)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predict_matches_jax(name):
    ref, port = _twins(0, vocab=VOCAB, dim=32, heads=4, hidden=32,
                       blocks=2, max_seq=64, **CONFIGS[name])
    toks = _tokens(len(name))
    got = port.call("predict", {"tokens": toks})
    want = ref.call("predict", {"tokens": toks})
    assert got.shape == (2, 48, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)
    stats = port.lowering_stats("predict")
    assert stats["attention-impl:flash"] == 2
    assert stats["extern:attention"] == 2


def test_predict_matches_interp_and_seeded_compile():
    """``compile(seed=...)`` draws the same parameters as the JAX package,
    and the port agrees with the numpy oracle too."""
    kw = dict(vocab=VOCAB, dim=16, heads=2, blocks=1)
    port = egt.compile(egt.models.flash_transformer(**kw), seed=3,
                       device="cpu")
    oracle = compile(exprgrad_tpu.models.flash_transformer(**kw),
                     backend="interp", seed=3)
    for tid, value in oracle.params.items():
        np.testing.assert_array_equal(port.params[tid].numpy(), value)
    toks = _tokens(5, t=16)
    np.testing.assert_allclose(port.call("predict", {"tokens": toks}),
                               oracle.call("predict", {"tokens": toks}),
                               **TOL)


def test_xla_impl_matches_jax():
    """impl="xla" runs the plain-attention path on both sides."""
    ref, port = _twins(1, vocab=VOCAB, dim=16, heads=2, blocks=1,
                       impl="xla")
    toks = _tokens(6, t=24)
    np.testing.assert_allclose(port.call("predict", {"tokens": toks}),
                               ref.call("predict", {"tokens": toks}), **TOL)
    assert port.lowering_stats("predict")["attention-impl:xla"] == 1


def test_ragged_length_runs_flash_where_jax_runs_xla():
    """A sequence above 128 that is no multiple of it misses the TPU
    kernels' block rule, so the JAX package attends through plain XLA;
    the port's ``auto`` takes the flash path and agrees."""
    ref, port = _twins(2, vocab=VOCAB, dim=16, heads=2, blocks=1,
                       max_seq=160)
    toks = _tokens(8, n=1, t=136)
    np.testing.assert_allclose(port.call("predict", {"tokens": toks}),
                               ref.call("predict", {"tokens": toks}), **TOL)
    assert port.lowering_stats("predict")["attention-impl:flash"] == 1
    assert ref.lowering_stats("predict")["attention-impl:xla"] == 1


def _train_data(seed, n=2, t=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (n, t)).astype(np.float32)
    labels = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (n, t))]
    return {"tokens": toks, "labels": labels}


def _steps(model, args, n):
    for _ in range(n):
        model.epoch += 1  # adam's bias correction needs epoch >= 1
        model.apply("train", args)


def _assert_same_state(port, ref, tol=TRAIN_TOL):
    assert port.epoch == ref.epoch
    for table, ref_table in ((port.params, ref.params),
                             (port.caches, ref.caches)):
        assert table.keys() == ref_table.keys()
        for tid, value in ref_table.items():
            np.testing.assert_allclose(table[tid].numpy(), np.asarray(value),
                                       **tol, err_msg=f"t{tid}")


SMALL = dict(vocab=VOCAB, dim=32, heads=4, hidden=32, blocks=2, max_seq=64)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_steps_match_jax(name):
    ref, port = _twins(0, **SMALL, **CONFIGS[name])
    args = _train_data(len(name))
    for _ in range(3):
        _steps(ref, args, 1)
        _steps(port, args, 1)
        np.testing.assert_allclose(port.call("loss", args),
                                   ref.call("loss", args), **TRAIN_TOL)
    _assert_same_state(port, ref)


def test_train_steps_match_interp():
    kw = dict(vocab=VOCAB, dim=16, heads=2, blocks=1)
    port = egt.compile(egt.models.flash_transformer(**kw), seed=4,
                       device="cpu")
    oracle = compile(exprgrad_tpu.models.flash_transformer(**kw),
                     backend="interp", seed=4)
    args = _train_data(9, t=12)
    _steps(port, args, 2)
    _steps(oracle, args, 2)
    _assert_same_state(port, oracle)


def test_train_lowering_guard():
    """As tests/test_flash_transformer.py guards the JAX package: the
    train step routes attention through the extern kernels (out + lse,
    then dq, dk, dv per block) and scatters only the embedding-table
    gradient."""
    port = egt.compile(egt.models.flash_transformer(**SMALL), seed=3,
                       device="cpu")
    _steps(port, _train_data(3), 1)
    stats = port.lowering_stats("train")
    assert stats.get("extern:attention") == 2 * 2
    assert stats.get("extern:attention_grad") == 3 * 2
    assert stats.get("attention-impl:flash") == 2
    assert stats.get("attention-grad-impl:flash") == 2
    assert stats.get("general-scatter", 0) <= 1
    assert "general-gather" not in stats


def test_flash_lm_recipe_matches_jax():
    """examples/flash_lm.py's recipe: adamw with decoupled decay, linear
    warmup into cosine annealing and global-norm clipping, all compiled
    into the train target."""
    def recipe(pkg):
        return pkg.layers.clip_by_global_norm(
            pkg.make_opt(pkg.layers.adamw,
                         eta=pkg.layers.warmup_cosine(0.02, warmup_steps=2,
                                                      total=6),
                         weight_decay=0.001),
            max_norm=1.0,
        )

    ref, port = _twins(1, vocab=6, dim=16, heads=2, opt=recipe)
    rng = np.random.default_rng(0)
    phase = rng.integers(0, 6, 8)
    toks = (phase[:, None] + np.arange(8)[None, :]) % 6
    args = {"tokens": toks.astype(np.float32),
            "labels": np.eye(6, dtype=np.float32)[(toks + 1) % 6]}
    _steps(ref, args, 6)
    _steps(port, args, 6)
    _assert_same_state(port, ref)
    np.testing.assert_allclose(port.call("loss", args),
                               ref.call("loss", args), **TRAIN_TOL)


def test_resume_from_reference_mid_training():
    """A JAX model trained for two steps continues on the port: params,
    adam moments, epoch and random stream come over with from_state."""
    ref = compile(exprgrad_tpu.models.flash_transformer(**SMALL, kv_heads=2),
                  backend="jax", seed=6)
    args = _train_data(6)
    _steps(ref, args, 2)
    port = _port_of(ref, egt.models.flash_transformer(**SMALL, kv_heads=2))
    assert port.epoch == 2
    _steps(ref, args, 2)
    _steps(port, args, 2)
    _assert_same_state(port, ref)


def test_scan_fit_matches_per_batch_fit_and_jax():
    """fit(scan_batches=True) on the port runs the same steps as the
    per-batch fit (equal bit for bit on the CPU) and as the JAX
    package's lax.scan epoch."""
    ref, scan = _twins(8, **SMALL)
    per_batch = _port_of(ref, egt.models.flash_transformer(**SMALL))
    data = _train_data(8, n=6)
    for _ in range(2):
        ref.fit("train", data, batch_size=2, log_status=False,
                scan_batches=True)
        scan.fit("train", data, batch_size=2, log_status=False,
                 scan_batches=True)
        per_batch.fit("train", data, batch_size=2, log_status=False)
    _assert_same_state(scan, ref)
    for table, other in ((scan.params, per_batch.params),
                         (scan.caches, per_batch.caches)):
        for tid, value in table.items():
            assert torch.equal(value, other[tid]), tid
