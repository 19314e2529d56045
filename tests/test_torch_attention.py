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
    """``auto`` asks the policy (``SchedulePolicy.attention``), as the JAX
    package's ``_pick_impl`` does: under the port's H100 calibration flash
    wins at these shapes, also those the JAX package sends to plain
    attention for its TPU block divisibility (``_flash_ok``, not carried
    over); under constants where plain attention wins, ``auto`` runs
    ``attention_forward_plain`` and records ``attention-impl:xla``; under
    the JAX package's constants the two choose alike where its blocks
    divide.  ``flash``/``xla`` are taken when asked for."""
    from exprgrad_torch.backend.policy import SchedulePolicy
    from exprgrad_tpu.backend.policy import SchedulePolicy as JaxPolicy

    q = torch.from_numpy(_qkv(1, 1, 1, sq, 8, 8)[0])
    k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 1, skv, skv, 8)[1:])
    shapes = [q.shape, k.shape]
    assert port_externs._pick_impl({"impl": "auto"}, shapes, None) == "flash"
    assert port_externs._pick_impl({}, shapes, None) == "flash"
    assert port_externs._pick_impl({"impl": "xla"}, shapes, None) == "xla"
    with pytest.raises(ValueError, match="unknown attention impl"):
        port_externs._pick_impl({"impl": "pallas"}, shapes, None)
    ctx = ExternContext(stats={}, policy=SchedulePolicy("auto"))
    out, lse = port_externs._attention([q, k, v], {"causal": True}, ctx)
    assert ctx.stats == {"attention-impl:flash": 1}
    want_out, want_lse = port.attention_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)

    slow = SchedulePolicy("force")  # the mode does not enter attention
    slow.constants = dict(slow.constants, flash_attention_tflops=1e-9)
    ctx = ExternContext(stats={}, policy=slow)
    out, _ = port_externs._attention([q, k, v], {"causal": True}, ctx)
    assert ctx.stats == {"attention-impl:xla": 1}
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)

    jpol = JaxPolicy("auto")
    ppol = SchedulePolicy("auto")
    ppol.constants = dict(
        ppol.constants, attention_plain_launch_us=0.0,
        attention_flash_launch_us=jpol.constants["pallas_launch_us"],
        flash_attention_tflops=jpol.constants["flash_attention_tflops"],
        plain_attention_tflops=jpol.constants["xla_attention_tflops"])

    class Ctx:
        policy = None

    jctx, pctx = Ctx(), Ctx()
    jctx.policy, pctx.policy = jpol, ppol
    got = port_externs._pick_impl({}, shapes, pctx)
    if jax_externs._flash_ok(sq, skv):
        assert got == jax_externs._pick_impl({}, shapes, jctx)


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


# --- flash_tile_counts: the CUDA kernels' grids ----------------------------

def test_flash_tile_counts_bench_shape():
    """The window bench shape (S=4096, W=512): each block of the CUDA
    kernels visits exactly its band, so every visited tile is live, at the
    kernels' own blocks and at the JAX kernel's 128-blocks (where the JAX
    banded grid visits 160 tiles of 150 live); the causal triangle visits
    as the JAX enumeration does."""
    from exprgrad_tpu.ops.attention import flash_tile_counts as jax_counts

    t = port.flash_tile_counts(4096, 4096, causal=True, window=512)
    for kern in ("fwd", "dq", "dkv"):
        assert t[kern] == {"visited": 1080, "live": 1080, "dead": 0}, t
    assert t["full"] == 128 * 64 and t["causal_visited"] == 4160
    assert t["tile_bound"] == round(4160 / 1080, 3)

    t = port.flash_tile_counts(4096, 4096, 128, 128, causal=True, window=512)
    j = jax_counts(4096, 4096, 128, 128, causal=True, window=512)
    assert set(t) == set(j)
    for kern in ("fwd", "dq", "dkv"):
        assert t[kern]["live"] == j[kern]["live"] == 150
        assert t[kern]["visited"] == 150 < j[kern]["visited"] == 160
    assert t["causal_visited"] == j["causal_visited"] == 528
    assert t["full"] == j["full"]


@pytest.mark.parametrize("bq,bk", [(128, 128), (128, 256), (256, 128),
                                   (64, 64), (32, 64)])
@pytest.mark.parametrize("s,causal", [(4096, True), (4096, False),
                                      (1024, True), (1024, False)])
def test_flash_tile_counts_match_jax_where_grids_agree(bq, bk, s, causal):
    """Causal without a window on a square shape (the JAX kernels'
    triangle enumeration) and non-causal (the full grid): the same blocks
    give the JAX function's counts, key for key; windowed, the live
    counts agree."""
    from exprgrad_tpu.ops.attention import flash_tile_counts as jax_counts

    assert port.flash_tile_counts(s, s, bq, bk, causal=causal) == \
        jax_counts(s, s, bq, bk, causal=causal)
    if causal:
        t = port.flash_tile_counts(s, s, bq, bk, window=300)
        j = jax_counts(s, s, bq, bk, window=300)
        for kern in ("fwd", "dq", "dkv"):
            assert t[kern]["live"] == j[kern]["live"]
            assert t[kern]["visited"] <= j[kern]["visited"]


def _live_brute(sq, skv, q_rows, kv_rows, causal, window):
    rows = np.arange(sq)[:, None]
    cols = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= cols > rows - window
    n = 0
    for q0 in range(0, sq, q_rows):
        for k0 in range(0, skv, kv_rows):
            n += bool(keep[q0:q0 + q_rows, k0:k0 + kv_rows].any())
    return n


@pytest.mark.parametrize("sq,skv,causal,window", [
    (4096, 4096, True, 512), (256, 256, True, None), (200, 77, True, None),
    (77, 200, True, None), (300, 300, True, 45), (1000, 96, False, None),
    (64, 64, True, 1), (33, 33, True, 7)])
def test_flash_tile_counts_invariants(sq, skv, causal, window):
    """visited = live + dead, visited <= the kernel's rectangular lattice,
    dead 0 (each block visits its band only), and live as a brute-force
    element mask counts it."""
    t = port.flash_tile_counts(sq, skv, causal=causal, window=window)
    lattices = {
        "fwd": (port.FWD_BLOCK_Q, port.FWD_BLOCK_K),
        "dq": (port.BWD_BLOCK, port.BWD_STREAM),
        "dkv": (port.BWD_STREAM, port.BWD_BLOCK),  # (query, kv) rows
    }
    for kern, (q_rows, kv_rows) in lattices.items():
        c = t[kern]
        rect = -(-sq // q_rows) * -(-skv // kv_rows)
        assert c["visited"] == c["live"] + c["dead"]
        assert c["visited"] <= rect and c["dead"] == 0
        assert c["live"] == _live_brute(sq, skv, q_rows, kv_rows, causal,
                                        window)
    assert t["fwd"]["visited"] <= t["full"]
    if sq == skv:
        assert all(t[k]["visited"] <= t["full"] for k in lattices)
    if window is not None:
        assert t["causal_visited"] >= t["fwd"]["visited"]
    with pytest.raises(ValueError, match="window requires causal"):
        port.flash_tile_counts(sq, skv, causal=False, window=4)
