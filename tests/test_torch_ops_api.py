"""The ``exprgrad_torch.ops`` package API against the JAX package's
``exprgrad_tpu.ops``: the same names, ``pallas_matmul`` mapped to the
port's ``scheduled_matmul`` (kernel B1 at an explicit block, as the
Pallas matmul takes explicit ``block_m/n/k``); each name the submodule's
own object; importable in a process where jax and the JAX package
cannot be imported, first of the port's modules (no import cycle),
building no kernel and importing no Triton."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import exprgrad_torch.ops as ops
import exprgrad_tpu.ops as jax_ops
from exprgrad_torch.ops import attention, decode, matmul, paged_attention

REPO = Path(__file__).resolve().parents[1]
# the JAX package's name -> the port's, where they differ
MAPPED = {"pallas_matmul": "scheduled_matmul"}


def test_all_names_the_jax_package_api():
    want = sorted(MAPPED.get(name, name) for name in jax_ops.__all__)
    assert sorted(ops.__all__) == want
    for name in ops.__all__:
        assert getattr(ops, name) is not None, name


@pytest.mark.parametrize("name,module", [
    ("KVCache", decode), ("append", decode), ("decode_attention", decode),
    ("init_cache", decode), ("flash_attention", attention),
    ("flash_attention_backward", attention),
    ("flash_attention_forward", attention),
    ("paged_decode_attention", paged_attention),
    ("scheduled_matmul", matmul)])
def test_each_name_is_the_submodules_own(name, module):
    assert getattr(ops, name) is getattr(module, name)


def test_scheduled_matmul_says_it_is_pallas_matmuls_counterpart():
    assert "pallas_matmul" in ops.scheduled_matmul.__doc__


SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["exprgrad_tpu"] = None
    from exprgrad_torch.ops import *  # noqa: F401,F403  (first, no cycle)
    import exprgrad_torch.ops as ops
    from exprgrad_torch.ops import (KVCache, append, decode_attention,
                                    flash_attention, flash_attention_backward,
                                    flash_attention_forward, init_cache,
                                    paged_decode_attention, scheduled_matmul)
    import exprgrad_torch
    from exprgrad_torch.utils import kernels, launcher
    assert "triton" not in sys.modules, "Triton imported"
    assert kernels._lib is None and launcher._lib is None, "a kernel built"
    import torch
    a = torch.randn(8, 16, dtype=torch.float64)
    b = torch.randn(16, 4, dtype=torch.float64)
    assert torch.allclose(scheduled_matmul(a, b), a @ b)
    assert sorted(ops.__all__) == sorted(n for n in dir(ops)
                                         if n in ops.__all__)
    print("NO_JAX_OK")
""")


def test_ops_import_with_jax_blocked_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
