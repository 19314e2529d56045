"""Paged KV cache: a shared page pool + per-request page tables.

Counterpart of ``exprgrad_tpu/ops/paged.py`` (the vLLM idea: Kwon et
al., "Efficient Memory Management for Large Language Model Serving with
PagedAttention", SOSP 2023).  The cache is carved into fixed-size pages
that requests borrow on demand, so cache memory is sized for the tokens
actually resident, not the worst case per slot:

* the pool is one static tensor ``[n_pages, hkv, page, d]`` per layer;
* a decode step writes each row's fresh K/V at ``(page_id, offset)``
  coordinates the host chose — one batched indexed store;
* attention either gathers each row's pages into a dense
  ``[b, hkv, P*page, d]`` view for ``ops.decode.decode_attention``, or
  reads the pages in place (``ops.paged_attention``, kernel B7).
  Garbage in never-written or recycled pages is masked by ``key_pos``,
  so freed pages are reused by overwriting, never zeroed;
* allocation, free lists and preemption live on the host
  (``models.batcher.ContinuousBatcher(paged=True)``).

The JAX package's pool is functional; here every ``write_*`` stores in
place and returns the pool.  int8 pools carry per-(page, head, slot)
scales exactly like ``ops.decode.KVCache``.  Everything here is plain
torch indexing (XLA on the TPU): no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .decode import _CACHE_DTYPES, KVCache, _quantize


class PagedKVPool(NamedTuple):
    """Page pool for one layer.  ``k``/``v``: [n_pages, hkv, page, d];
    scales (int8 pools): [n_pages, hkv, page] float32."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k.shape[0]


def init_pool(n_pages: int, kv_heads: int, page_size: int, head_dim: int,
              dtype=torch.bfloat16, device="cuda") -> PagedKVPool:
    if dtype not in _CACHE_DTYPES:
        raise ValueError(
            f"pool dtype must be float32, bfloat16 or int8, not {dtype}")
    shape = (n_pages, kv_heads, page_size, head_dim)
    quantized = dtype == torch.int8
    return PagedKVPool(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        k_scale=(torch.ones(shape[:3], dtype=torch.float32, device=device)
                 if quantized else None),
        v_scale=(torch.ones(shape[:3], dtype=torch.float32, device=device)
                 if quantized else None),
    )


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def write_token(pool: PagedKVPool, k_new: torch.Tensor, v_new: torch.Tensor,
                page_ids, offsets) -> PagedKVPool:
    """Write ``t`` fresh positions per batch row (in place): ``k_new`` /
    ``v_new`` [b, hkv, t, d] land at ``(page_ids[b, t], offsets[b, t])``
    ([b] accepted for t = 1, the plain decode step).  Rows own distinct
    pages (the host scheduler guarantees it), so no two writes meet;
    parked rows may all write the trash page, whose contents nobody
    reads."""
    dev = pool.k.device
    hkv, t = pool.k.shape[1], k_new.shape[2]
    pid = _ids(page_ids, dev).reshape(-1, t)[:, None, :]          # [b,1,t]
    off = _ids(offsets, dev).reshape(-1, t)[:, None, :]           # [b,1,t]
    head = torch.arange(hkv, device=dev)[None, :, None]           # [1,hkv,1]
    if pool.k_scale is not None:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        pool.k[pid, head, off] = kq
        pool.v[pid, head, off] = vq
        pool.k_scale[pid, head, off] = ks
        pool.v_scale[pid, head, off] = vs
    else:
        pool.k[pid, head, off] = k_new.to(pool.k.dtype)
        pool.v[pid, head, off] = v_new.to(pool.v.dtype)
    return pool


def _copy_pages(pool, cache, page_ids, starts):
    """Copy dense rows ``starts[p]:starts[p] + page`` of a batch-1 cache
    into page ``page_ids[p]`` (a region cut short by the cache's end
    fills the front of the page)."""
    pg = pool.page_size
    if isinstance(page_ids, torch.Tensor):
        page_ids = page_ids.cpu()
    pids = [int(p) for p in np.asarray(page_ids).reshape(-1)]
    for page, at in zip(pids, starts):
        sl = slice(at, at + pg)
        rows = cache.k[0, :, sl].shape[1]
        pool.k[page, :, :rows] = cache.k[0, :, sl].to(pool.k.dtype)
        pool.v[page, :, :rows] = cache.v[0, :, sl].to(pool.v.dtype)
        if pool.k_scale is not None:
            pool.k_scale[page, :, :rows] = cache.k_scale[0, :, sl]
            pool.v_scale[page, :, :rows] = cache.v_scale[0, :, sl]
    return pool


def write_prefill(pool: PagedKVPool, cache: KVCache, page_ids,
                  src_offset: int = 0) -> PagedKVPool:
    """Copy a batch-1 dense prefill cache into ``P = len(page_ids)`` pool
    pages (in place), starting at dense row ``src_offset`` (page-aligned:
    prefix-cached admissions copy only the suffix region).  Dense-cache
    and pool quantization agree bit for bit, so a paged prefill equals a
    dense one exactly."""
    n = len(page_ids)
    pg = pool.page_size
    return _copy_pages(pool, cache, page_ids,
                       [src_offset + p * pg for p in range(n)])


def write_prefill_at(pool: PagedKVPool, cache: KVCache, page_ids,
                     src_offset) -> PagedKVPool:
    """:func:`write_prefill` with the offset clamped as the JAX version's
    ``dynamic_slice`` clamps a traced offset: a page's source region
    that would pass the cache's end starts at ``capacity - page``
    instead."""
    n = len(page_ids)
    pg = pool.page_size
    last = cache.k.shape[2] - pg
    return _copy_pages(pool, cache, page_ids,
                       [min(max(int(src_offset) + p * pg, 0), last)
                        for p in range(n)])


def gather_rows(pool: PagedKVPool, page_ids):
    """Dense batch-1 rows of the given pages: ``(k, v, k_scale,
    v_scale)`` with k/v ``[1, hkv, P*page, d]`` — the prefix half of a
    prefix-cached admission's scratch cache."""
    pt = _ids(page_ids, pool.k.device).reshape(-1)
    P = pt.shape[0]
    _, hkv, pg, d = pool.k.shape

    def dense(buf):
        return buf[pt].transpose(0, 1).reshape(1, hkv, P * pg, d)

    def dense_scale(buf):
        return buf[pt].transpose(0, 1).reshape(1, hkv, P * pg)

    return (
        dense(pool.k),
        dense(pool.v),
        None if pool.k_scale is None else dense_scale(pool.k_scale),
        None if pool.v_scale is None else dense_scale(pool.v_scale),
    )


def gather_view(pool: PagedKVPool, page_table) -> KVCache:
    """Materialize each row's pages as a dense position-ordered cache view
    [b, hkv, P*page, d] for ``decode_attention``.  ``page_table`` [b, P]
    holds pool page ids (unallocated entries must name a real page, for
    example 0: their rows are masked by ``key_pos``).  ``length`` is 0
    and meaningless on the paged path (callers pass positions)."""
    pt = _ids(page_table, pool.k.device)
    b, P = pt.shape
    _, hkv, pg, d = pool.k.shape

    def dense(buf):
        g = buf[pt]                                  # [b, P, hkv, pg, d]
        return g.transpose(1, 2).reshape(b, hkv, P * pg, d)

    def dense_scale(buf):
        g = buf[pt]                                  # [b, P, hkv, pg]
        return g.transpose(1, 2).reshape(b, hkv, P * pg)

    return KVCache(
        k=dense(pool.k),
        v=dense(pool.v),
        length=0,
        k_scale=None if pool.k_scale is None else dense_scale(pool.k_scale),
        v_scale=None if pool.v_scale is None else dense_scale(pool.v_scale),
    )
