"""Port parity: the model extras ``export_compiled``, ``load_compiled``,
``save_hlo`` and ``profile`` (exprgrad_torch/model.py).

The JAX package's export tests (tests/test_introspection.py's round trip
and trained-model tests, tests/test_flash_transformer.py's
extern-attention predict), run on the port on the CPU:

* the artifact round-trips through bytes and through a path, and keeps
  its weights after the live model's are zeroed;
* after training it serves the trained weights;
* ``flash_transformer``'s predict, attention extern included, serves
  within ``rtol=1e-5`` of ``model.call`` and of the JAX package's
  artifact on the same weights, and holds the op
  ``exprgrad_torch::flash_fwd`` (kernel B2 on the card);
* a scheduled contraction under ``schedule_mode="force"`` holds
  ``exprgrad_torch::matmul`` (kernel B1), and ``save_hlo`` names both ops;
* RANDOM tensors are fixed to the export's ``seed``;
* ``profile`` writes a Chrome trace into ``logdir``;
* refusals: a weight-quantized model and a target with no output (as
  the JAX package);
* a plan that launches a generated kernel (B6, B5) exports: the graph
  holds ``exprgrad_torch::rowchain`` or ``exprgrad_torch::mapreduce``,
  ``save_hlo`` names it, and the artifact equals ``model.call`` here and
  in a fresh process that imports only exprgrad_torch.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers  # noqa: F401  (egt.layers in the builders)
import exprgrad_tpu as eg
import exprgrad_tpu.models as jm
from exprgrad_torch.errors import ModelRuntimeError
from exprgrad_torch.models import flash_transformer, xor_mlp

XOR = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.float32)
VOCAB = 16


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_export_compiled_roundtrip(tmp_path):
    model = egt.compile(xor_mlp(), seed=0, device="cpu")
    want = model.call("predict", {"x": XOR})
    path = tmp_path / "xor.egc"
    data = model.export_compiled("predict", {"x": [4, 2]}, path=str(path))
    assert path.read_bytes() == data
    got = egt.load_compiled(str(path))({"x": XOR})
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), want, rtol=1e-6)
    # bytes work too, and the artifact holds its own weights
    fn = egt.load_compiled(data)
    for tid in model.params:
        model.params[tid] = model.params[tid] * 0.0
    np.testing.assert_allclose(_np(fn({"x": XOR})), want, rtol=1e-6)
    for value in model.caches.values():
        value.zero_()
    np.testing.assert_allclose(_np(fn({"x": torch.from_numpy(XOR)})), want,
                               rtol=1e-6)


def test_export_compiled_trained_model():
    model = egt.compile(xor_mlp(), seed=0, device="cpu")
    y = np.array([[0], [1], [1], [0]], dtype=np.float32)
    for _ in range(200):
        model.apply("train", {"x": XOR, "y": y})
    want = model.call("predict", {"x": XOR})
    got = egt.load_compiled(model.export_compiled("predict", {"x": [4, 2]}))
    np.testing.assert_allclose(_np(got({"x": XOR})), want, rtol=1e-6)


@pytest.fixture(scope="module")
def flash_pair():
    ref = eg.compile(jm.flash_transformer(vocab=VOCAB, dim=16, heads=2),
                     backend="jax", seed=4)
    port = egt.from_state(flash_transformer(vocab=VOCAB, dim=16, heads=2),
                          ref.params, ref.caches, ref.epoch,
                          ref._rng.bit_generator.state, device="cpu")
    return ref, port


def test_flash_transformer_export_roundtrip(flash_pair):
    ref, port = flash_pair
    toks = np.random.default_rng(4).integers(0, VOCAB, (2, 8)).astype(
        np.float32)
    data = port.export_compiled("predict", {"tokens": [2, 8]})
    served = egt.load_compiled(data)
    live = port.call("predict", {"tokens": toks})
    aot = _np(served({"tokens": toks}))
    np.testing.assert_allclose(aot, live, rtol=1e-5, atol=1e-6)
    jax_aot = np.asarray(eg.load_compiled(ref.export_compiled(
        "predict", {"tokens": [2, 8]}))({"tokens": toks}))
    np.testing.assert_allclose(aot, jax_aot, rtol=1e-5, atol=1e-6)
    program = torch.export.load(io.BytesIO(data))
    ops = {str(n.target) for n in program.graph.nodes
           if n.op == "call_function"}
    assert "exprgrad_torch.flash_fwd.default" in ops, ops
    assert not any("scaled_dot_product" in op for op in ops), ops


def _scheduled_matmul(m):
    y, x, it = m.iters("y", "x", "it")
    out = m.Fun("out")
    out[y, x] = m.input("a")[y, it] * m.param([16, 8])[it, x]
    out.schedule(tile={"y": 8, "x": 8, "it": 8}, parallel=["y", "x"])
    return out.target("out")


def test_save_hlo_names_the_custom_ops(flash_pair, tmp_path):
    _, port = flash_pair
    path = tmp_path / "predict.txt"
    port.save_hlo(str(path), "predict", {"tokens": [2, 8]})
    text = path.read_text()
    assert "torch.ops.exprgrad_torch.flash_fwd.default" in text
    raw = tmp_path / "raw.txt"
    port.save_hlo(str(raw), "predict", {"tokens": [2, 8]}, optimized=False)
    assert "exprgrad_torch.flash_fwd" in raw.read_text()

    mm = egt.compile(_scheduled_matmul(egt), seed=0, device="cpu",
                     schedule_mode="force")
    a = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
    want = mm.call("out", {"a": a})
    assert mm.lowering_stats("out") == {"matmul": 1}
    mm.save_hlo(str(path), "out", {"a": [32, 16]})
    assert "torch.ops.exprgrad_torch.matmul.default" in path.read_text()
    got = egt.load_compiled(mm.export_compiled("out", {"a": [32, 16]}))
    np.testing.assert_allclose(_np(got({"a": a})), want, rtol=1e-6)


def _noisy(m):
    """``out = x + rand(x, (0, 1))``: one RANDOM tensor."""
    i = m.iters("i")
    x = m.input("x")
    out = m.Fun("out")
    out[i] = x[i] + m.rand(x, (0.0, 1.0))[i]
    return out.target("out")


def test_random_tensors_fixed_to_the_seed():
    model = egt.compile(_noisy(egt), seed=0, device="cpu")
    x = np.zeros(64, np.float32)
    a = _np(egt.load_compiled(model.export_compiled("out", {"x": [64]},
                                                    seed=3))({"x": x}))
    b = _np(egt.load_compiled(model.export_compiled("out", {"x": [64]},
                                                    seed=3))({"x": x}))
    c = _np(egt.load_compiled(model.export_compiled("out", {"x": [64]},
                                                    seed=4))({"x": x}))
    fn = egt.load_compiled(model.export_compiled("out", {"x": [64]}, seed=3))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_np(fn({"x": x})), _np(fn({"x": x})))
    assert not np.array_equal(a, c)
    assert ((a >= 0.0) & (a < 1.0)).all()


def test_profile_writes_a_chrome_trace(flash_pair, tmp_path):
    _, port = flash_pair
    toks = np.zeros((2, 8), np.float32)
    logdir = tmp_path / "logs"
    assert port.profile("predict", {"tokens": toks}, str(logdir)) is None
    (name,) = os.listdir(logdir)
    assert name == "predict.pt.trace.json"
    trace = json.loads((logdir / name).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "exprgrad_torch::flash_fwd" in names


def test_refusals(flash_pair):
    ref, port = flash_pair
    for model, err in ((ref, eg.ModelRuntimeError),
                       (port, ModelRuntimeError)):
        with pytest.raises(err, match="no output"):
            model.export_compiled("train", {"tokens": [2, 8],
                                            "labels": [2, 8, VOCAB]})
    for m, kw, err in ((eg, dict(backend="jax"), eg.ModelRuntimeError),
                       (egt, dict(device="cpu"), ModelRuntimeError)):
        q = m.compile(m.models.xor_mlp(), seed=0, **kw)
        q.quantize_weights(min_size=1)
        with pytest.raises(err, match="quantized"):
            q.export_compiled("predict", {"x": [4, 2]})
    with pytest.raises(ModelRuntimeError, match="not a target"):
        port.export_compiled("nope", {"tokens": [2, 8]})


def _softmax_rows(m):
    """One B6 launch: softmax over rows, a chain of three kernels."""
    x = m.input("x")
    return m.layers.softmax(x, rank=2, row_tile=8).target("out")


def _rowsum(m):
    """One B5 launch: a scheduled reduction."""
    y, c = m.iters("y", "c")
    out = m.Fun("out")
    out[y] = m.exp(m.input("x")[y, c])
    out.schedule(tile={"y": 8})
    return out.target("out")


_LOAD_IN_CHILD = """
import sys
import numpy as np
import exprgrad_torch as egt
args = dict(np.load(sys.argv[2]))
got = egt.load_compiled(sys.argv[1])(args)
np.save(sys.argv[3], got.numpy())
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu")))
"""


@pytest.mark.parametrize("build,stat,op", [
    (_softmax_rows, "rowchain", "exprgrad_torch.rowchain"),
    (_rowsum, "mapreduce", "exprgrad_torch.mapreduce"),
], ids=["B6 softmax", "B5 reduction"])
def test_generated_kernels_export(build, stat, op, tmp_path):
    """A plan that launches B5 or B6 exports (ROADMAP A15): the graph
    holds the op ``exprgrad_torch::rowchain`` or ``::mapreduce`` (the
    generated kernel on the card, its plain version here), ``save_hlo``
    names it, and the artifact equals ``model.call`` in this process and
    in a fresh one that imports only exprgrad_torch."""
    import subprocess
    import sys

    x = np.random.default_rng(1).normal(size=(16, 32)).astype(np.float32)
    model = egt.compile(build(egt), device="cpu", schedule_mode="force")
    want = model.call("out", {"x": x})
    assert model.lowering_stats("out") == {stat: 1}
    (ex,) = model._executors.values()
    assert len(ex.generated_kernels()) == 1
    path = tmp_path / "out.egc"
    data = model.export_compiled("out", {"x": [16, 32]}, path=str(path))
    program = torch.export.load(io.BytesIO(data))
    ops = {str(n.target) for n in program.graph.nodes
           if n.op == "call_function"}
    assert f"{op}.default" in ops, ops
    np.testing.assert_allclose(_np(egt.load_compiled(data)({"x": x})), want,
                               rtol=1e-5, atol=1e-6)
    hlo = tmp_path / "out.txt"
    model.save_hlo(str(hlo), "out", {"x": [16, 32]})
    assert f"torch.ops.{op}.default" in hlo.read_text()
    np.savez(tmp_path / "args.npz", x=x)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(egt.__file__))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    run = subprocess.run(
        [sys.executable, "-c", _LOAD_IN_CHILD, str(path),
         str(tmp_path / "args.npz"), str(tmp_path / "got.npy")],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]", run.stdout
    np.testing.assert_allclose(np.load(tmp_path / "got.npy"), want,
                               rtol=1e-5, atol=1e-6)
