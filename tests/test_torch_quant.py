"""Port parity: weight-only int8 quantization (exprgrad_torch/quant.py,
``Model.quantize_weights``, ``FlashLMServer(weight_dtype=)``).

Each package quantizes the same weights with its own code: the int8
codes must be equal bit for bit and the scales within ``rtol=1e-6``;
the inferred contraction axes must agree on dense and conv programs; the
guards of tests/test_quantize_model.py must raise alike; and a quantized
model's predict must agree with the JAX package's quantized model within
``rtol=1e-4, atol=1e-5`` (the serving bound of test_torch_serve.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import exprgrad_torch as egt
import exprgrad_tpu as eg
from exprgrad_torch.models import FlashLMServer
from exprgrad_torch.quant import (QuantW, check_weight_dtype, dequantize,
                                  infer_quant_axes, quantize_weight)
from exprgrad_tpu.models.serve import FlashLMServer as JaxServer
from exprgrad_tpu.quant import QuantW as JaxQuantW
from exprgrad_tpu.quant import infer_quant_axes as jax_infer_quant_axes
from exprgrad_tpu.quant import quantize_weight as jax_quantize_weight

from tests.test_torch_serve import VOCAB, _trained

TOL = dict(rtol=1e-4, atol=1e-5)


def _same_quant(got: QuantW, want: JaxQuantW):
    assert got.codes.dtype == torch.int8
    np.testing.assert_array_equal(got.codes.cpu().numpy(),
                                  np.asarray(want.codes))
    np.testing.assert_allclose(got.scale.cpu().numpy(),
                               np.asarray(want.scale), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape,axes", [((16, 24), 0), ((4, 16, 8), 1),
                                        ((4, 8, 16), (0, 1)),
                                        ((6, 3, 3, 5), (1, 2, 3))])
def test_quantize_weight_matches_jax(shape, axes):
    """Codes bit for bit, including weights on exact half steps (round
    half to even), and the elementwise bound scale / 2."""
    rng = np.random.default_rng(len(shape))
    w = rng.normal(size=shape).astype(np.float32)
    w.reshape(-1)[:5] = [0.5, -1.5, 2.5, 0.0, 127.5]
    got = quantize_weight(torch.as_tensor(w), axes)
    _same_quant(got, jax_quantize_weight(w, axes))
    err = (torch.as_tensor(w) - dequantize(got)).abs()
    assert bool((err <= got.scale * 0.5 + 1e-7).all())
    assert dequantize(torch.ones(2), torch.float64).dtype == torch.float64


def _mlp(m, hidden=64, train=True):
    layers = importlib.import_module(m.__name__ + ".layers")
    net = (m.input("x").pipe(layers.dense, 8, hidden).pipe(layers.relu)
           .pipe(layers.dense, hidden, 4).pipe(layers.sigmoid)
           .target("predict"))
    if train:
        net = (net.pipe(layers.mse, m.input("y")).target("loss")
               .backprop(m.make_opt(layers.gradient_descent, rate=0.1))
               .target("train"))
    return net


def _conv(m):
    layers = importlib.import_module(m.__name__ + ".layers")
    return layers.conv2(m.input("images"), m.input("filters")).target("out")


def test_infer_axes_match_jax_on_dense_and_conv():
    for build, target in ((lambda m: _mlp(m, 16), "predict"),
                          (_conv, "out")):
        ref = eg.compile(build(eg), seed=0)
        port = egt.compile(build(egt), seed=0, device="cpu")
        tids = sorted(set(ref.program.params) | set(ref.program.inputs
                                                     .values()))
        got = [infer_quant_axes(port.program, t, target) for t in tids]
        want = [jax_infer_quant_axes(ref.program, t, target) for t in tids]
        assert got == want
        assert any(a is not None for a in got)
    flt = port.program.inputs["filters"]
    assert infer_quant_axes(port.program, flt, "out") == (1, 2, 3)


def test_quantized_mlp_matches_jax_and_guards():
    ref = eg.compile(_mlp(eg), seed=3)
    port = egt.from_state(_mlp(egt), ref.params, ref.caches, ref.epoch,
                          ref._rng.bit_generator.state, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((16, 8), dtype=np.float32)
    y = rng.random((16, 4), dtype=np.float32)
    full = port.call("predict", {"x": x})
    done = port.quantize_weights(min_size=32)
    assert done == ref.quantize_weights(min_size=32) == {"weights": (0,)}
    quant = [t for t, v in port.params.items() if isinstance(v, QuantW)]
    assert sorted(quant) == sorted(ref._quantized_tids) and len(quant) == 2
    for tid in quant:
        _same_quant(port.params[tid], ref.params[tid])
    got = port.call("predict", {"x": x})
    np.testing.assert_allclose(got, ref.call("predict", {"x": x}), **TOL)
    rel = np.linalg.norm(got - full) / np.linalg.norm(full)
    assert rel < 0.02, rel
    assert "[8, 64]" in port.summary() and "[64, 4]" in port.summary()

    # the guards of tests/test_quantize_model.py, raised alike
    for model, err in ((ref, eg.ModelRuntimeError),
                       (port, egt.ModelRuntimeError)):
        with pytest.raises(err, match="inference-only"):
            model.apply("train", {"x": x, "y": y})
        for scan in (False, True):
            with pytest.raises(err, match="inference-only"):
                model.fit("train", {"x": x, "y": y}, batch_size=8,
                          log_status=False, scan_batches=scan)
        with pytest.raises(err, match="astype"):
            model.astype("float64" if model is port else "bfloat16")
        assert model.quantize_weights(min_size=32) == {}
        with pytest.raises(err, match="int8"):
            model.quantize_weights(dtype="float16")
        with pytest.raises(err, match="target"):
            model.quantize_weights(target_name="nope")
        io = importlib.import_module(
            ("exprgrad_torch" if model is port else "exprgrad_tpu") + ".io")
        with pytest.raises(err, match="checkpoint"):
            io.save_model(model, "never-written.egt")
        with pytest.raises(err, match="npz"):
            io.export_params_npz(model, "never-written.npz")
    # the entry checks the same dtypes as the JAX package's
    check_weight_dtype(torch.int8)
    check_weight_dtype("int8")
    with pytest.raises(egt.ModelRuntimeError, match="int8"):
        check_weight_dtype(torch.float16)


def test_quantized_transformer_predict_matches_jax():
    """Embeddings and positions decline (gather reads); the attention
    and FFN matrices quantize; predict runs the flash forward over the
    dequantized weights."""
    ref, port = _trained()
    toks = np.random.default_rng(1).integers(0, VOCAB, (3, 8)).astype(
        np.float32)
    full = port.call("predict", {"tokens": toks})
    done = port.quantize_weights(min_size=64)
    assert done == ref.quantize_weights(min_size=64)
    assert "embed" not in done and "pos" not in done and "weights" in done
    for tid in ref._quantized_tids:
        _same_quant(port.params[tid], ref.params[tid])
    got = port.call("predict", {"tokens": toks})
    np.testing.assert_allclose(got, ref.call("predict", {"tokens": toks}),
                               **TOL)
    assert port.lowering_stats("predict")["attention-impl:flash"] == 1
    assert (np.argmax(got, -1) == np.argmax(full, -1)).mean() > 0.99
    with pytest.raises(egt.ModelRuntimeError, match="weight_dtype"):
        FlashLMServer(port)


@pytest.mark.parametrize("kw", [dict(), dict(rope=True, tie_embeddings=True),
                                dict(ffn="swiglu", hidden=16)],
                         ids=["mha", "rope_tied", "swiglu"])
def test_int8_server_matches_jax(kw):
    """FlashLMServer(weight_dtype=int8): the same codes and scales as the
    JAX server, every matrix int8 within scale / 2, logits within the
    serving bound of the JAX int8 server, and the same greedy tokens."""
    ref, port = _trained(**kw)
    jq = JaxServer(ref, cache_dtype=jnp.float32, weight_dtype=jnp.int8)
    tq = FlashLMServer(port, cache_dtype=torch.float32,
                       weight_dtype=torch.int8)
    full = FlashLMServer(port, cache_dtype=torch.float32)
    n = 0
    for blk_j, blk_t, blk_f in zip(jq.blocks, tq.blocks, full.blocks):
        for wj, wt, wf in zip(blk_j, blk_t, blk_f):
            assert isinstance(wt, QuantW) == isinstance(wj, JaxQuantW)
            if isinstance(wt, QuantW):
                n += 1
                _same_quant(wt, wj)
                err = (wf - dequantize(wt)).abs()
                assert bool((err <= wt.scale * 0.5 + 1e-7).all())
    assert n == (7 if "ffn" in kw else 6) * len(tq.blocks)
    _same_quant(tq.w_head, jq.w_head)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (4, 8)).astype(
        np.float32)
    lj, _ = jq.prefill(jnp.asarray(prompt), jq.init_caches(4))
    lt, _ = tq.prefill(prompt, tq.init_caches(4))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    lf, _ = full.prefill(prompt, full.init_caches(4))
    rel = float(torch.linalg.norm(lt - lf) / torch.linalg.norm(lf))
    assert rel < 0.05, rel
    np.testing.assert_array_equal(
        tq.generate(prompt, n_new=8).numpy(),
        np.asarray(jq.generate(prompt, n_new=8)))


def test_weight_dtype_and_mesh_validation():
    _, port = _trained(steps=1)
    with pytest.raises(egt.ModelRuntimeError, match="int8"):
        FlashLMServer(port, weight_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="A14"):
        FlashLMServer(port, mesh=object())
