"""KV-cache incremental decoding (serving path).

Counterpart of ``exprgrad_tpu/ops/decode.py`` for float32 and bfloat16
caches (the int8 cache and ``append_at`` are not ported yet).  The JAX
package keeps the cache functional and masks the whole static capacity;
PyTorch runs eagerly, so here ``append`` writes the new rows in place
(no copy of the cache per token) and ``decode_attention`` attends only
the ``length`` filled rows.  The masked rows the JAX version also scores
contribute exactly zero there, so the result is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_NEG_INF = -1e30


class KVCache(NamedTuple):
    """Static-capacity key/value cache; ``length`` rows are filled."""

    k: torch.Tensor   # [b, hkv, capacity, d]
    v: torch.Tensor   # [b, hkv, capacity, d]
    length: int


def init_cache(batch: int, kv_heads: int, capacity: int, head_dim: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cache dtype must be float32 or bfloat16, not {dtype}")
    shape = (batch, kv_heads, capacity, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
    )


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
    cache.k[:, :, cache.length:end] = k_new
    cache.v[:, :, cache.length:end] = v_new
    return cache._replace(length=end)


def decode_attention(q: torch.Tensor, cache: KVCache,
                     sm_scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attend ``q`` [b, h, t, d] (the t newest tokens, already appended to
    the cache) against the cache.  Query i sits at position
    ``length - t + i`` and sees positions ``<= that``, restricted to the
    last ``window`` positions when given.  Returns [b, h, t, d] in q's
    dtype."""
    b, h, t, d = q.shape
    hkv = cache.k.shape[1]
    if h % hkv:
        raise ValueError(f"query heads ({h}) not a multiple of kv ({hkv})")
    group = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    n = cache.length
    qg = q.reshape(b, hkv, group * t, d).float()
    kf = cache.k[:, :, :n].float()
    vf = cache.v[:, :, :n].float()
    s = torch.einsum("bgqd,bgsd->bgqs", qg, kf) * sm_scale
    s = s.reshape(b, h, t, n)
    pos = n - t + torch.arange(t, device=q.device)            # [t]
    kp = torch.arange(n, device=q.device)                     # [n]
    mask = kp[None, :] <= pos[:, None]                        # [t, n]
    if window is not None:
        mask = mask & (kp[None, :] > pos[:, None] - window)
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgqs,bgsd->bgqd", p.reshape(b, hkv, group * t, n), vf)
    return out.reshape(b, h, t, d).to(q.dtype)
