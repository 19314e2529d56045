"""The port runs without jax: import, compile, predict and generate on the
CPU in a fresh interpreter where ``import jax`` fails.

The check runs in a subprocess because this test process already holds
jax (the parity tests import it); ``sys.modules["jax"] = None`` makes any
later ``import jax`` raise ImportError.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import exprgrad_torch as egt
from exprgrad_tpu.models import flash_transformer

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
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
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_compile_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = flash_transformer(vocab=8, dim=8, heads=2, blocks=1)
    with pytest.raises(RuntimeError, match="is_available"):
        egt.compile(graph, seed=0)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="is_available"):
        egt.compile(graph, seed=0, device="cuda:0")
