"""KV-cache incremental decoding (serving path).

Counterpart of ``exprgrad_tpu/ops/decode.py``: float32, bfloat16 and
int8 caches, ``append``, per-row cursors (``append_at``) and position
masking.  The JAX package keeps the cache functional; PyTorch runs
eagerly, so here ``append`` and ``append_at`` write the new rows in
place (no copy of the cache per token) and return the cache.

``decode_attention`` without positions attends only the ``length``
filled rows (the JAX version masks the whole static capacity; the rows
it also scores contribute exactly zero, so the result is the same).
With ``key_pos``/``q_pos`` it masks the whole capacity by position and
ignores ``length``, as the JAX version does: that is the path of ragged
batches, per-row cursors and paged views.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_NEG_INF = -1e30
_CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


class KVCache(NamedTuple):
    """Static-capacity key/value cache; ``length`` rows are filled.

    With an int8 cache ``k_scale``/``v_scale`` hold one float32
    dequantization scale per (batch, kv head, slot): symmetric per-row
    max/127 quantization.  None for float caches."""

    k: torch.Tensor   # [b, hkv, capacity, d]
    v: torch.Tensor   # [b, hkv, capacity, d]
    length: int
    k_scale: Optional[torch.Tensor] = None  # [b, hkv, capacity] float32
    v_scale: Optional[torch.Tensor] = None  # [b, hkv, capacity] float32


def init_cache(batch: int, kv_heads: int, capacity: int, head_dim: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    if dtype not in _CACHE_DTYPES:
        raise ValueError(
            f"cache dtype must be float32, bfloat16 or int8, not {dtype}")
    shape = (batch, kv_heads, capacity, head_dim)
    quantized = dtype == torch.int8
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
        k_scale=(torch.ones(shape[:3], dtype=torch.float32, device=device)
                 if quantized else None),
        v_scale=(torch.ones(shape[:3], dtype=torch.float32, device=device)
                 if quantized else None),
    )


def _quantize(x: torch.Tensor):
    """Symmetric per-(b, h, slot) int8 quantization: (int8 codes, float32
    scales).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _store(cache, index, k_new, v_new):
    """Write ``k_new``/``v_new`` into the cache buffers at ``index`` (a
    tuple indexing [b, hkv, slot]), quantizing for an int8 cache."""
    if cache.k_scale is not None:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        cache.k[index] = kq
        cache.v[index] = vq
        cache.k_scale[index] = ks
        cache.v_scale[index] = vs
    else:
        cache.k[index] = k_new.to(cache.k.dtype)
        cache.v[index] = v_new.to(cache.v.dtype)


def append(cache: KVCache, k_new: torch.Tensor,
           v_new: torch.Tensor) -> KVCache:
    """Write ``t`` new positions at ``cache.length`` (in place) and return
    the cache with the new length."""
    t = k_new.shape[2]
    end = cache.length + t
    if end > cache.k.shape[2]:
        raise ValueError(
            f"cache overflow: {end} rows needed, capacity {cache.k.shape[2]}"
        )
    _store(cache, (slice(None), slice(None), slice(cache.length, end)),
           k_new, v_new)
    return cache._replace(length=end)


def append_at(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
              row_starts: torch.Tensor) -> KVCache:
    """Write ``t`` new positions PER ROW at per-row slot offsets
    ``row_starts`` [b] (in place) — the continuous-batching primitive:
    every batch row owns its own fill cursor.  ``cache.length`` is
    meaningless under per-row cursors and is left unchanged; callers
    track per-row lengths and pass ``key_pos``/``q_pos`` to
    :func:`decode_attention`.  A row whose ``t`` slots would pass the
    capacity is written at ``capacity - t``, as the JAX version's
    ``dynamic_update_slice`` clamps its start."""
    b, _, t, _ = k_new.shape
    cap = cache.k.shape[2]
    dev = cache.k.device
    starts = torch.as_tensor(row_starts, device=dev).long().clamp(0, cap - t)
    slots = starts[:, None] + torch.arange(t, device=dev)[None, :]  # [b, t]
    rows = torch.arange(b, device=dev)[:, None, None]
    heads = torch.arange(cache.k.shape[1], device=dev)[None, :, None]
    _store(cache, (rows, heads, slots[:, None, :]), k_new, v_new)
    return cache


def decode_attention(q: torch.Tensor, cache: KVCache,
                     sm_scale: Optional[float] = None,
                     window: Optional[int] = None,
                     key_pos: Optional[torch.Tensor] = None,
                     q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attend ``q`` [b, h, t, d] (the t newest tokens, already appended to
    the cache) against the cache.  Query i sits at position
    ``length - t + i`` and sees positions ``<= that``, restricted to the
    last ``window`` positions when given.  Returns [b, h, t, d] in q's
    dtype.

    For ragged batches, per-row cursors and paged views pass true
    positions instead: ``key_pos`` [b, capacity] gives each cache slot's
    position with ``-1`` marking a dead slot, ``q_pos`` [b, t] the fresh
    tokens' positions.  The mask then follows positions over the whole
    capacity and ``length`` is not read."""
    b, h, t, d = q.shape
    hkv = cache.k.shape[1]
    if h % hkv:
        raise ValueError(f"query heads ({h}) not a multiple of kv ({hkv})")
    if (key_pos is None) != (q_pos is None):
        raise ValueError("key_pos and q_pos must be given together")
    group = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    n = cache.length if key_pos is None else cache.k.shape[2]
    qg = q.reshape(b, hkv, group * t, d).float()
    kf = cache.k[:, :, :n].float()
    vf = cache.v[:, :, :n].float()
    if cache.k_scale is not None:  # int8 cache: dequantize on the fly
        kf = kf * cache.k_scale[:, :, :n, None]
        vf = vf * cache.v_scale[:, :, :n, None]
    s = torch.einsum("bgqd,bgsd->bgqs", qg, kf) * sm_scale
    s = s.reshape(b, h, t, n)
    if key_pos is None:
        pos = n - t + torch.arange(t, device=q.device)            # [t]
        kp = torch.arange(n, device=q.device)                     # [n]
        mask = kp[None, :] <= pos[:, None]                        # [t, n]
        if window is not None:
            mask = mask & (kp[None, :] > pos[:, None] - window)
    else:
        kp = torch.as_tensor(key_pos, device=q.device).long()[:, None, :]
        qp = torch.as_tensor(q_pos, device=q.device).long()[:, :, None]
        mask = (kp >= 0) & (kp <= qp)                             # [b, t, n]
        if window is not None:
            mask = mask & (kp > qp - window)
        mask = mask[:, None]                                      # [b,1,t,n]
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgqs,bgsd->bgqd", p.reshape(b, hkv, group * t, n), vf)
    return out.reshape(b, h, t, d).to(q.dtype)
