"""Port parity: flash-attention forward (exprgrad_torch/ops/attention.py).

The plain PyTorch version of the CUDA kernel — what the wrapper runs for
CPU tensors — is held against the JAX package's Pallas flash forward (in
interpret mode, as the JAX package's own tests run it), its plain-XLA
attention and the numpy oracle, on the same numpy inputs.  Tolerances:
float32 ``rtol=1e-5, atol=1e-6``; float64 ``rtol=1e-10`` against the
float64 oracle (the lse output is float32 by contract in both packages,
so it is held to float32 precision).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exprgrad_tpu.ops import externs as jax_externs
from exprgrad_tpu.ops.attention import flash_attention_forward as jax_flash
from exprgrad_torch.ops import attention as port
from exprgrad_torch.ops import externs as port_externs
from exprgrad_torch.registry import ExternContext
from exprgrad_torch.utils import kernels

F32 = dict(rtol=1e-5, atol=1e-6)


def _qkv(b, h, hkv, sq, skv, d, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    return q, k, v


def _port(q, k, v, **kw):
    out, lse = port.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    return out.numpy(), lse.numpy()


def _jax(q, k, v, scale, causal, offsets=None, window=None):
    out, lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale, causal, block_q=16, block_k=16,
                         interpret=True, offsets=offsets, window=window)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_plain_matches_jax_flash_and_xla(causal, hkv):
    q, k, v = _qkv(2, 4, hkv, 48, 48, 16, seed=hkv)
    scale = 0.3
    out, lse = _port(q, k, v, sm_scale=scale, causal=causal)
    ref_out, ref_lse = _jax(q, k, v, scale, causal)
    np.testing.assert_allclose(out, ref_out, **F32)
    np.testing.assert_allclose(lse, ref_lse, **F32)
    xla_out, xla_lse = jax_externs._jax_xla_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal)
    np.testing.assert_allclose(out, np.asarray(xla_out), **F32)
    np.testing.assert_allclose(lse, np.asarray(xla_lse), **F32)


@pytest.mark.parametrize("sq,skv", [(16, 48), (48, 16), (32, 64)])
def test_plain_rectangular_non_causal(sq, skv):
    q, k, v = _qkv(1, 2, 2, sq, skv, 8, seed=sq + skv)
    out, lse = _port(q, k, v)
    ref_out, ref_lse = _jax(q, k, v, None, False)
    np.testing.assert_allclose(out, ref_out, **F32)
    np.testing.assert_allclose(lse, ref_lse, **F32)


@pytest.mark.parametrize("window,hkv", [(1, 2), (7, 1), (16, 2), (40, 2)])
def test_plain_sliding_window(window, hkv):
    q, k, v = _qkv(2, 2, hkv, 64, 64, 8, seed=window)
    out, lse = _port(q, k, v, causal=True, window=window)
    ref_out, ref_lse = _jax(q, k, v, None, True, window=window)
    np.testing.assert_allclose(out, ref_out, **F32)
    np.testing.assert_allclose(lse, ref_lse, **F32)
    xla_out, xla_lse = jax_externs._jax_xla_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1 / np.sqrt(8), True,
        window)
    np.testing.assert_allclose(out, np.asarray(xla_out), **F32)
    np.testing.assert_allclose(lse, np.asarray(xla_lse), **F32)


@pytest.mark.parametrize("offsets,window", [
    ((32, 0), None),     # queries after every key: all live
    ((16, 0), 24),       # shifted shard with a window
    ((0, 16), None),     # rows 0..15 see no key
    ((0, 64), None),     # a shard with no live key at all
    ((48, 16), 8),
])
def test_plain_offsets_match_jax(offsets, window):
    """Rows with a live key agree with the TPU kernel.  A row without one
    gives out 0 and lse -inf; the TPU kernel gives that where it never
    visits the row's tiles, and a tile-size-dependent value where a
    visited tile holds the row fully masked, so those rows are held to
    the port's own contract only."""
    q, k, v = _qkv(1, 2, 1, 32, 32, 8, seed=sum(offsets))
    out, lse = _port(q, k, v, causal=True, offsets=offsets, window=window)
    ref_out, ref_lse = _jax(q, k, v, None, True,
                            offsets=np.asarray(offsets, np.int32),
                            window=window)
    rows = np.arange(32)[:, None] + offsets[0]
    cols = np.arange(32)[None, :] + offsets[1]
    keep = cols <= rows
    if window is not None:
        keep &= cols > rows - window
    live = keep.any(axis=1)
    np.testing.assert_allclose(out[:, :, live], ref_out[:, :, live], **F32)
    np.testing.assert_allclose(lse[:, live], ref_lse[:, live], **F32)
    assert np.all(out[:, :, ~live] == 0.0)
    assert np.all(np.isneginf(lse[:, ~live]))
    assert np.all(np.isneginf(lse[np.isneginf(ref_lse)]))


def test_dead_shard_gives_zero_and_neg_inf():
    q, k, v = _qkv(1, 2, 2, 16, 16, 8)
    out, lse = _port(q, k, v, causal=True, offsets=(0, 16))
    assert np.all(out == 0.0)
    assert np.all(np.isneginf(lse))


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)])
def test_plain_float64_matches_oracle(causal, window):
    q, k, v = _qkv(2, 4, 2, 24, 24, 8, dtype=np.float64, seed=3)
    attrs = {"causal": causal, "scale": 0.25, "window": window or 0}
    out, lse = _port(q, k, v, sm_scale=0.25, causal=causal, window=window)
    ref_out, _ = jax_externs._np_attention([q, k, v], attrs)
    ke, _ = jax_externs._np_expand(q, k, v)
    _, ref_lse = jax_externs._np_weights(q, ke, 0.25, causal, window)
    assert out.dtype == np.float64 and lse.dtype == np.float32
    np.testing.assert_allclose(out, ref_out, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lse, ref_lse.reshape(-1, 24), rtol=1e-6)


def test_cpu_tensors_never_count_launches():
    q, k, v = _qkv(1, 1, 1, 8, 8, 4)
    before = port.launches
    _port(q, k, v, causal=True)
    assert port.launches == before


def test_wrapper_rejects_other_devices_and_bad_shapes():
    meta = torch.empty(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        port.flash_attention_forward(meta, meta, meta)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 2, 8, 8, 4))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port.flash_attention_forward(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 4))
    with pytest.raises(ValueError, match="window requires causal"):
        port.flash_attention_forward(q, k, v, window=4)


@pytest.mark.parametrize("sq,skv", [(64, 64), (128, 256), (200, 200),
                                    (256, 384), (96, 1000)])
def test_auto_routes_to_flash(sq, skv):
    """On the port ``auto`` means the flash kernel for every shape, also
    those the JAX package sends to plain attention for its TPU block
    divisibility; ``xla`` is taken only when asked for."""
    q = torch.from_numpy(_qkv(1, 1, 1, sq, 8, 8)[0])
    k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 1, skv, skv, 8)[1:])
    assert port_externs._pick_impl({"impl": "auto"}) == "flash"
    assert port_externs._pick_impl({}) == "flash"
    assert port_externs._pick_impl({"impl": "xla"}) == "xla"
    with pytest.raises(ValueError, match="unknown attention impl"):
        port_externs._pick_impl({"impl": "pallas"})
    ctx = ExternContext(stats={})
    out, lse = port_externs._attention([q, k, v], {"causal": True}, ctx)
    assert ctx.stats == {"attention-impl:flash": 1}
    want_out, want_lse = port.attention_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def test_kernel_library_is_keyed_by_sources():
    path = kernels.library_path()
    assert path == kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libegt_kernels_") and path.suffix == ".so"
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "exprgrad_torch")
