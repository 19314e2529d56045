"""Port parity: flash-attention backward (exprgrad_torch/ops/attention.py).

``attention_backward_plain`` — what ``flash_attention_backward`` runs for
CPU tensors, and the oracle of the dq/dkv CUDA kernels on the card — is
held against the JAX package's Pallas backward (in interpret mode, as the
JAX package's own tests run it), its plain-XLA ``xla_attention_vjp`` and
the numpy oracle, on the same numpy inputs.

Tolerances: float32 ``rtol=1e-5, atol=1e-5`` (both sides sum in float32
in other orders; gradients here are of order 1); float64 ``rtol=1e-10``
against the float64 oracle; bfloat16 against float32 math on the same
rounded inputs, one bfloat16 step (``rtol=atol=1e-2``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exprgrad_tpu.ops import externs as jax_externs
from exprgrad_tpu.ops.attention import (
    flash_attention_backward as jax_flash_bwd,
    flash_attention_forward as jax_flash_fwd,
    xla_attention_vjp,
)
from exprgrad_torch.ops import attention as port
from exprgrad_torch.ops import externs as port_externs
from exprgrad_torch.registry import ExternContext

F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _inputs(b, h, hkv, sq, skv, d, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    g = rng.standard_normal((b, h, sq, d)).astype(dtype)
    return q, k, v, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port_grads(q, k, v, g, **kw):
    """Port forward then backward on CPU tensors: numpy (dq, dk, dv)."""
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = port.flash_attention_forward(tq, tk, tv, **kw)
    grads = port.flash_attention_backward(tq, tk, tv, out, lse, tg, **kw)
    return [x.numpy() for x in grads]


def _jax_grads(q, k, v, g, scale=None, causal=False, offsets=None,
               window=None, block=16):
    args = [jnp.asarray(a) for a in (q, k, v)]
    offs = None if offsets is None else np.asarray(offsets, np.int32)
    out, lse = jax_flash_fwd(*args, scale, causal, block_q=block,
                             block_k=block, interpret=True, offsets=offs,
                             window=window)
    grads = jax_flash_bwd(*args, out, lse, jnp.asarray(g), scale, causal,
                          block_q=block, block_k=block, interpret=True,
                          offsets=offs, window=window)
    return [np.asarray(x) for x in grads]


def _assert_grads(got, want, tol):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, **tol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_backward_matches_jax_flash(causal, hkv):
    q, k, v, g = _inputs(2, 4, hkv, 48, 48, 16, seed=hkv + 10 * causal)
    got = _port_grads(q, k, v, g, sm_scale=0.3, causal=causal)
    want = _jax_grads(q, k, v, g, 0.3, causal)
    _assert_grads(got, want, F32)


@pytest.mark.parametrize("window,hkv", [(1, 2), (7, 1), (16, 2), (40, 4)])
def test_backward_sliding_window_matches_jax(window, hkv):
    q, k, v, g = _inputs(2, 4, hkv, 64, 64, 8, seed=window)
    got = _port_grads(q, k, v, g, causal=True, window=window)
    want = _jax_grads(q, k, v, g, None, True, window=window)
    _assert_grads(got, want, F32)


@pytest.mark.parametrize("offsets,window", [
    ((32, 0), None),     # queries after every key
    ((16, 0), 24),       # a shifted shard with a window
    ((48, 16), None),
])
def test_backward_offsets_match_jax(offsets, window):
    """Global offsets (the ring-attention building block), at shapes where
    every row has a live key."""
    q, k, v, g = _inputs(1, 2, 1, 32, 32, 8, seed=sum(offsets))
    got = _port_grads(q, k, v, g, causal=True, offsets=offsets,
                      window=window)
    want = _jax_grads(q, k, v, g, None, True, offsets=offsets,
                      window=window)
    _assert_grads(got, want, F32)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (20, 20, True, None),    # ragged: no block of the TPU kernels fits
    (37, 37, True, 5),
    (16, 48, False, None),   # rectangular
    (48, 16, False, None),
    (37, 53, False, None),
])
def test_backward_matches_xla_vjp(sq, skv, causal, window):
    q, k, v, g = _inputs(2, 2, 2, sq, skv, 8, seed=sq + skv)
    got = _port_grads(q, k, v, g, causal=causal, window=window)
    want = xla_attention_vjp(*(jnp.asarray(a) for a in (q, k, v, g)),
                             None, causal, window)
    _assert_grads(got, [np.asarray(x) for x in want], F32)


@pytest.mark.parametrize("causal,window,hkv", [(False, None, 2),
                                               (True, None, 1),
                                               (True, 5, 2)])
def test_plain_backward_float64_matches_oracle(causal, window, hkv):
    q, k, v, g = _inputs(2, 4, hkv, 24, 24, 8, dtype=np.float64, seed=3)
    attrs = {"causal": causal, "scale": 0.25, "window": window or 0}
    out, lse = jax_externs._np_attention([q, k, v], attrs)
    got = port.attention_backward_plain(
        *_t(q, k, v, out, lse, g), sm_scale=0.25, causal=causal,
        window=window)
    want = jax_externs._np_attention_grad([q, k, v, out, lse, g], attrs)
    assert all(x.dtype == torch.float64 for x in got)
    _assert_grads([x.numpy() for x in got], want, F64)


@pytest.mark.parametrize("offsets,window", [((0, 16), None), ((0, 4), 8),
                                            ((0, 64), None)])
def test_dead_rows_get_zero_dq_and_add_nothing(offsets, window):
    """Rows with no live key: dq is 0, they add nothing to dk/dv, and no
    NaN appears (exp(-1e30 - lse) with lse = -inf would give inf * 0).
    dk/dv equal the gradients of the live rows alone."""
    q, k, v, g = _inputs(1, 2, 1, 32, 32, 8, seed=5)
    kw = dict(causal=True, offsets=offsets, window=window)
    dq, dk, dv = _port_grads(q, k, v, g, **kw)
    rows = np.arange(32)[:, None] + offsets[0]
    cols = np.arange(32)[None, :] + offsets[1]
    keep = cols <= rows
    if window is not None:
        keep &= cols > rows - window
    live = keep.any(axis=1)
    assert (~live).any()
    for x in (dq, dk, dv):
        assert np.isfinite(x).all()
    assert np.all(dq[:, :, ~live] == 0.0)
    if not live.any():
        assert np.all(dk == 0.0) and np.all(dv == 0.0)
        return
    # the live rows alone, as a shard that starts at the first live row
    first = int(np.argmax(live))
    sub = [a[:, :, first:] for a in (q, g)]
    kw_live = dict(kw, offsets=(offsets[0] + first, offsets[1]))
    dq_live, dk_live, dv_live = _port_grads(sub[0], k, v, sub[1], **kw_live)
    np.testing.assert_allclose(dq[:, :, first:], dq_live, **F32)
    np.testing.assert_allclose(dk, dk_live, **F32)
    np.testing.assert_allclose(dv, dv_live, **F32)


def test_plain_backward_bfloat16_computes_in_float32():
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(1, 2, 1, 16, 16, 8, seed=7))
    out, lse = port.flash_attention_forward(q, k, v, causal=True)
    got = port.flash_attention_backward(q, k, v, out, lse, g, causal=True)
    want = port.attention_backward_plain(
        *(x.float() for x in (q, k, v, out)), lse, g.float(), causal=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, **BF16)


@pytest.mark.parametrize("causal,window,hkv", [(False, None, 2),
                                               (True, None, 1),
                                               (True, 3, 2)])
def test_flash_attention_gradcheck_float64(causal, window, hkv):
    """``flash_attention`` (torch.autograd.Function) against finite
    differences, in float64 through the plain versions."""
    q, k, v, _ = _inputs(1, 2, hkv, 6, 6, 4, dtype=np.float64, seed=11)
    inputs = [t.requires_grad_() for t in _t(q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: port.flash_attention(q, k, v, causal=causal,
                                             window=window),
        inputs)


def test_flash_attention_matches_forward_and_backward():
    q, k, v, g = _t(*_inputs(2, 4, 2, 24, 24, 8, seed=13))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = port.flash_attention(qg, kg, vg, causal=True)
    out.backward(g)
    ref_out, lse = port.flash_attention_forward(q, k, v, causal=True)
    torch.testing.assert_close(out.detach(), ref_out, rtol=0, atol=0)
    want = port.flash_attention_backward(q, k, v, ref_out, lse, g,
                                         causal=True)
    for t, w in zip((qg, kg, vg), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("hkv", [4, 2])
def test_attention_grad_extern_matches_jax(impl, hkv):
    q, k, v, g = _inputs(2, 4, hkv, 32, 32, 8, seed=hkv)
    attrs = {"causal": True, "impl": impl}
    out, lse = jax_externs._jax_attention(
        [jnp.asarray(a) for a in (q, k, v)], attrs, None)
    out, lse = np.array(out), np.array(lse)
    jctx, pctx = ExternContext(stats={}), ExternContext(stats={})
    want = jax_externs._jax_attention_grad(
        [jnp.asarray(a) for a in (q, k, v, out, lse, g)], attrs, jctx)
    got = port_externs._attention_grad(_t(q, k, v, out, lse, g), attrs,
                                       pctx)
    _assert_grads([x.numpy() for x in got], [np.asarray(x) for x in want],
                  F32)
    assert pctx.stats == jctx.stats == {f"attention-grad-impl:{impl}": 1}


def test_attention_grad_auto_is_flash_and_takes_non_contiguous_inputs():
    q, k, v, g = _t(*_inputs(1, 2, 2, 16, 16, 8, seed=17))
    out, lse = port.flash_attention_forward(q, k, v, causal=True)
    # a transposed view: the extern makes contiguous copies
    qt = q.transpose(2, 3).contiguous().transpose(2, 3)
    assert not qt.is_contiguous()
    ctx = ExternContext(stats={})
    got = port_externs._attention_grad([qt, k, v, out, lse, g],
                                       {"causal": True}, ctx)
    assert ctx.stats == {"attention-grad-impl:flash": 1}
    want = port.attention_backward_plain(q, k, v, out, lse, g, causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_backward_never_counts_launches():
    q, k, v, g = _inputs(1, 1, 1, 8, 8, 4)
    before = (port.launches, port.dq_launches, port.dkv_launches)
    _port_grads(q, k, v, g, causal=True)
    assert (port.launches, port.dq_launches, port.dkv_launches) == before


def test_kernel_launchers_take_only_cuda_tensors():
    q, k, v, g = _t(*_inputs(1, 2, 2, 8, 8, 4))
    out, lse = port.flash_attention_forward(q, k, v)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        port.flash_bwd_dq(q, k, v, out, lse, g)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        port.flash_bwd_dkv(q, k, v, lse, lse, g)
    meta = torch.empty(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        port.flash_attention_backward(meta, meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="window requires causal"):
        port.flash_attention_backward(q, k, v, out, lse, g, window=4)
