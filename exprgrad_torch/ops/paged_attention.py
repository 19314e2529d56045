"""Paged decode attention: kernel B7 and its plain twin.

Counterpart of ``exprgrad_tpu/ops/paged_attention.py``.  The kernel,
``exprgrad_torch/csrc/paged_attention.cu``, attends the fresh query rows
of each batch row against that row's KV pages in place: no dense copy of
the resident cache is made, so it crosses device memory once per decode
step instead of twice (gather, then read).  It splits each row's page
table into :func:`split_plan`'s contiguous ranges, one block each, and
merges the splits' partial softmaxes in split order in a second kernel;
the plan depends on the table's shape and the grid alone, so a decode
dispatch reads nothing back from the card.

:func:`paged_decode_attention` launches it for CUDA tensors and raises on
anything it cannot take.  For CPU tensors — and only for them — it runs
:func:`paged_decode_attention_plain`, the JAX package's own oracle
(``decode_attention`` over ``gather_view`` of the table, entries below 0
read as page 0), which is also what the kernel is checked against on the
card.  A query row that sees no live key gives 0 on both (the JAX
kernel's -1e30 fill gives the mean of the visited V there instead).

Not ported, as TPU-only knobs: ``interpret``, ``head_mode``, ``h_block``
and the VMEM budget; the page size need not be a multiple of 8 (a
Mosaic sublane rule).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..utils import kernels
from .decode import decode_attention
from .paged import PagedKVPool, gather_view

# kernel launches since the last reset; chip_smoke.py reads it to prove
# the paged decode path ran through the kernel
launches = 0

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 128
# query rows one block of the kernel holds (csrc/paged_attention.cu
# kMaxRows) and the blocks per SM the split plan aims for
_MAX_ROWS = 8
_WAVES = 2
# slots a split holds at least: two 32-slot chunks for each of a block's
# four warps.  The merge is a launch of its own: at path (e)'s decode step
# (8 entries of 32 slots) one split took 0.0056 ms of device time and two
# 0.0078 on an H100 80GB HBM3 at 700 W (scripts/probe_torch_kernels.py
# --variants b7)
_MIN_SLOTS = 8 * 32


def rows_per_block(rows: int) -> int:
    """The kernel's rows per block: the fewest of 1, 4 or 8 that hold the
    group's ``rows`` query rows (8 when there are more)."""
    return next((r for r in (1, 4) if rows <= r), _MAX_ROWS)


def split_plan(P: int, page: int, blocks: int, sms: int) -> tuple[int, int]:
    """``(n_split, pages per split)`` of a table of ``P`` entries of
    ``page`` slots whose unsplit grid has ``blocks`` blocks: at least
    enough splits for ``_WAVES`` blocks per SM where the table has the
    entries, each of at least one page and of ``_MIN_SLOTS`` slots, and no
    empty split.  Split ``z`` covers entries ``[z * per, min(P, (z + 1) *
    per))``."""
    P = max(int(P), 1)
    want = max(1, -(-_WAVES * sms // max(int(blocks), 1)))
    per = max(1, P // want, -(-_MIN_SLOTS // max(int(page), 1)))
    per = min(per, P)
    return -(-P // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, pool, page_table, key_pos, q_pos):
    """The JAX package's shape checks; returns (b, h, t, d, hkv, page, P)."""
    b, h, t, d = q.shape
    _, hkv, page, dk = pool.k.shape
    bt, P = page_table.shape
    if dk != d:
        raise ValueError(f"head_dim mismatch: q {d} vs pool {dk}")
    if h % hkv:
        raise ValueError(f"query heads ({h}) not a multiple of kv ({hkv})")
    if bt != b:
        raise ValueError(f"page_table batch {bt} != q batch {b}")
    if tuple(key_pos.shape) != (b, P * page):
        raise ValueError(
            f"key_pos shape {tuple(key_pos.shape)} != {(b, P * page)}")
    if tuple(q_pos.shape) != (b, t):
        raise ValueError(f"q_pos shape {tuple(q_pos.shape)} != {(b, t)}")
    return b, h, t, d, hkv, page, P


def _live_rows(key_pos, q_pos, window):
    """[b, t] bool: which query tokens see at least one key."""
    kp = key_pos.long()[:, None, :]
    qp = q_pos.long()[:, :, None]
    keep = (kp >= 0) & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    return keep.any(dim=-1)


def paged_decode_attention_plain(q, pool: PagedKVPool, page_table, key_pos,
                                 q_pos, *, sm_scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """``decode_attention(q, gather_view(pool, max(table, 0)), key_pos=,
    q_pos=)``, with the rows that see no key set to 0 — the plain
    PyTorch version of kernel B7."""
    _check(q, pool, page_table, key_pos, q_pos)
    view = gather_view(pool, page_table.clamp(min=0))
    out = decode_attention(q, view, sm_scale=sm_scale, window=window,
                           key_pos=key_pos, q_pos=q_pos)
    live = _live_rows(key_pos.to(q.device), q_pos.to(q.device), window)
    return out.masked_fill(~live[:, None, :, None], 0.0)


def paged_decode_attention(q: torch.Tensor, pool: PagedKVPool,
                           page_table: torch.Tensor, key_pos: torch.Tensor,
                           q_pos: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Attend ``q`` [b, h, t, d] against each row's pages in place.

    ``page_table`` [b, P] holds pool page ids (``-1`` = unallocated);
    ``key_pos`` [b, P*page] gives each virtual slot's true position with
    ``-1`` marking dead slots; ``q_pos`` [b, t] the fresh tokens'
    positions.  The masking contract is
    ``ops.decode.decode_attention(..., key_pos=, q_pos=)``'s; returns
    [b, h, t, d] in q's dtype.

    CUDA tensors launch kernel B7 (q float32 or bfloat16; pool float32,
    bfloat16, or int8 with scales; ``d <= 128``; integer tables and
    positions, taken as int32) or raise; CPU tensors run
    :func:`paged_decode_attention_plain`."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool, page_table, key_pos, q_pos, sm_scale=sm_scale,
            window=window)
    b, h, t, d, hkv, page, P = _check(q, pool, page_table, key_pos, q_pos)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, not {q.dtype}")
    if pool.k.dtype not in _KV_DTYPES or pool.v.dtype != pool.k.dtype:
        raise ValueError(
            f"pool must be float32, bfloat16 or int8, not {pool.k.dtype} / "
            f"{pool.v.dtype}")
    quant = pool.k.dtype == torch.int8
    if quant and (pool.k_scale is None or pool.v_scale is None):
        raise ValueError("an int8 pool needs k_scale and v_scale")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window})")
    tensors = dict(q=q, k=pool.k, v=pool.v, page_table=page_table,
                   key_pos=key_pos, q_pos=q_pos)
    if quant:
        tensors.update(k_scale=pool.k_scale, v_scale=pool.v_scale)
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("page_table", "key_pos", "q_pos"):
        if tensors[name].dtype.is_floating_point:
            raise ValueError(f"{name} must be an integer tensor")
        tensors[name] = tensors[name].to(torch.int32)
    if quant and (pool.k_scale.dtype != torch.float32
                  or pool.v_scale.dtype != torch.float32):
        raise ValueError("k_scale and v_scale must be float32")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    # 16-byte loads of K and V: whole rows of 16-byte units, aligned pools
    vec = int((d * pool.k.element_size()) % 16 == 0
              and pool.k.data_ptr() % 16 == 0
              and pool.v.data_ptr() % 16 == 0)
    rows = (h // hkv) * t
    blocks = b * hkv * -(-rows // rows_per_block(rows))
    n_split, per = split_plan(P, page, blocks, _sm_count(
        q.device.index if q.device.index is not None
        else torch.cuda.current_device()))
    out = torch.empty_like(q)
    # each split's (acc[d], m, l) per query row, in float32
    part = (torch.empty(n_split * b * hkv * rows * (d + 2),
                        dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    kernels.call(
        "egt_paged_decode", q.device,
        q.data_ptr(), pool.k.data_ptr(), pool.v.data_ptr(),
        pool.k_scale.data_ptr() if quant else None,
        pool.v_scale.data_ptr() if quant else None,
        tensors["page_table"].data_ptr(), tensors["key_pos"].data_ptr(),
        tensors["q_pos"].data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, b, h, hkv,
        pool.k.shape[0], t, d, page, P, float(sm_scale),
        int(window or 0), vec, n_split, per, _Q_DTYPES[q.dtype],
        _KV_DTYPES[pool.k.dtype])
    global launches
    launches += 1
    return out
