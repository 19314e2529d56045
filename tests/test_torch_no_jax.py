"""The port runs without jax and without the JAX package: import,
compile, predict and generate, a scheduled MLP (chip_smoke.py's program,
narrow), a scheduled softmax row chain and scatter-add (the generated
kernels' plain versions), and train (steps, fit, the scan epoch,
checkpoints, EMA, the training driver) on the CPU in a fresh interpreter
where ``import jax`` and ``import exprgrad_tpu`` fail.

The check runs in a subprocess because this test process already holds
both (the parity tests import them); ``sys.modules[name] = None`` makes
any later import of ``name`` raise ImportError.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import exprgrad_torch as egt
from exprgrad_torch.models import flash_transformer

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["exprgrad_tpu"] = None
    import numpy as np
    import torch
    import exprgrad_torch as egt
    from exprgrad_torch.models import FlashLMServer, flash_transformer

    model = egt.compile(flash_transformer(vocab=12, dim=16, heads=2,
                                          kv_heads=1, blocks=1, max_seq=32),
                        seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, 12, (2, 16)).astype(
        np.float32)
    probs = model.call("predict", {"tokens": toks})
    assert probs.shape == (2, 16, 12), probs.shape
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert model.lowering_stats("predict")["attention-impl:flash"] == 1
    out = FlashLMServer(model).generate(toks[:, :8], n_new=5)
    assert out.shape == (2, 5), out.shape

    import exprgrad_torch.layers
    from chip_smoke import scheduled_mlp
    mlp = egt.compile(scheduled_mlp(egt, dim=8, hidden=16, tile=8), seed=0,
                      schedule_mode="force", device="cpu")
    rows = np.random.default_rng(1).normal(size=(12, 8)).astype(np.float32)
    assert mlp.call("predict", {"v": rows}).shape == (12, 8)
    assert mlp.lowering_stats("predict") == {"matmul-fused": 2}

    # the generated map/reduce and row-chain kernels (their plain
    # versions on the CPU), built by the modules of B5 and B6
    from chip_smoke import fam_scatter_add, softmax_chain
    import exprgrad_torch.backend.mapreduce, exprgrad_torch.backend.rowchain
    import exprgrad_torch.ops.mapreduce, exprgrad_torch.ops.rowchain
    import exprgrad_torch.utils.triton_build
    for build, stat in ((lambda m: softmax_chain(m, {"y": 16}, 32, 64),
                         {"rowchain": 1}), (fam_scatter_add,
                                            {"mapreduce": 1})):
        graph, args = build(egt)
        prog = egt.compile(graph, seed=0, schedule_mode="force",
                           device="cpu")
        name = next(iter(prog.program.targets))
        assert np.isfinite(prog.call(name, args)).all()
        assert prog.lowering_stats(name) == stat, prog.lowering_stats(name)
    assert "triton" not in sys.modules  # imported only at a launch
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


TRAIN_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["exprgrad_tpu"] = None
    import numpy as np
    import exprgrad_torch as egt
    from exprgrad_torch import io, make_opt, train
    from exprgrad_torch.layers import adam, with_ema
    from exprgrad_torch.models import flash_transformer

    graph = flash_transformer(vocab=8, dim=16, heads=2, kv_heads=1,
                              blocks=1, max_seq=16,
                              opt=with_ema(make_opt(adam, eta=0.01), 0.9))
    model = egt.compile(graph, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 8, (4, 8))
    data = {"tokens": toks.astype(np.float32),
            "labels": np.eye(8, dtype=np.float32)[(toks + 1) % 8]}
    model.epoch += 1
    model.apply("train", data)
    assert model.lowering_stats("train")["attention-grad-impl:flash"] == 1
    model.fit("train", data, batch_size=2, log_status=False,
              scan_batches=True)
    history = train.train(model, "train", data, epochs=2, batch_size=2,
                          validation=data, patience=1)
    assert history and model.ema_params()
    path = os.path.join(tempfile.mkdtemp(), "model.egt")
    io.save_model(model, path)
    loaded = io.load_model(path, device="cpu")
    assert np.allclose(loaded.call("predict", {"tokens": data["tokens"]}),
                       model.call("predict", {"tokens": data["tokens"]}))
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu")
                  and sys.modules[m] is not None)
    assert not mods, mods
    print("NO_JAX_OK")
""")


def _run_blocked(script):
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_runs_with_jax_blocked():
    _run_blocked(SCRIPT)


def test_port_trains_with_jax_blocked():
    _run_blocked(TRAIN_SCRIPT)


def test_compile_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = flash_transformer(vocab=8, dim=8, heads=2, blocks=1)
    with pytest.raises(RuntimeError, match="is_available"):
        egt.compile(graph, seed=0)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="is_available"):
        egt.compile(graph, seed=0, device="cuda:0")
