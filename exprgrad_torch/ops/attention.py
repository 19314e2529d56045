"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Counterpart of ``exprgrad_tpu/ops/attention.py`` (forward half:
``_forward``/``flash_attention_forward``).  The kernel is
``exprgrad_torch/csrc/flash_fwd.cu``; :func:`flash_attention_forward`
launches it for CUDA tensors and raises on anything it cannot take.
For CPU tensors — and only for them — it runs
:func:`attention_forward_plain`, straightforward masked-softmax math that
also serves as the oracle the kernel is checked against on the card.

The backward kernels (dq, dkv) are not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..utils import kernels

NEG_INF = -1e30  # the masked-score constant of the TPU kernels

# kernel launches since the last reset; chip_smoke.py reads it to prove the
# main path ran through the kernel
launches = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def _check(q, k, v, causal, window, offsets):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [batch, heads, seq, head_dim]")
    b, h, _, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    hkv = k.shape[1]
    if hkv < 1 or h % hkv:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({hkv})"
        )
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
    if offsets is not None and len(offsets) != 2:
        raise ValueError("offsets must be (q_offset, k_offset)")


def _keep_mask(sq, skv, causal, window, offsets, device):
    """[sq, skv] bool: which (row, col) pairs attend, in global positions."""
    q_off, k_off = offsets if offsets is not None else (0, 0)
    rows = torch.arange(sq, device=device)[:, None] + int(q_off)
    cols = torch.arange(skv, device=device)[None, :] + int(k_off)
    keep = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        keep = keep & (cols <= rows)
    if window is not None:
        keep = keep & (cols > rows - int(window))
    return keep


def attention_forward_plain(q, k, v, sm_scale: Optional[float] = None,
                            causal: bool = False,
                            offsets: Optional[Sequence[int]] = None,
                            window: Optional[int] = None):
    """``(out [b,h,sq,d], lse [b*h, sq])`` by masked softmax over the whole
    score matrix — the plain PyTorch version of the CUDA kernel.

    Scores and sums run in float32 (float64 for float64 inputs); masked
    scores take -1e30 as on the TPU.  A row with no live key gives
    ``out = 0`` and ``lse = -inf``, as the TPU kernel does for a row
    whose tiles it never visits."""
    _check(q, k, v, causal, window, offsets)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(cdt), k.to(cdt)) * sm_scale
    keep = _keep_mask(sq, skv, causal, window, offsets, q.device)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, v.to(cdt))
    lse = (m + torch.log(l))[..., 0]
    live = keep.any(dim=-1)  # [sq]
    out = out.masked_fill(~live[:, None], 0.0)
    lse = lse.masked_fill(~live, -math.inf)
    return out.to(q.dtype), lse.reshape(b * h, sq).to(torch.float32)


def flash_attention_forward(q, k, v, sm_scale: Optional[float] = None,
                            causal: bool = False,
                            offsets: Optional[Sequence[int]] = None,
                            window: Optional[int] = None):
    """Flash-attention forward returning ``(out, lse)``.

    ``q`` [b, h, sq, d]; ``k``/``v`` [b, hkv, skv, d] with ``h % hkv == 0``
    (grouped-query attention).  ``offsets = (q_offset, k_offset)`` puts the
    causal/window mask in global positions (sequence shards).

    CUDA tensors launch the CUDA kernel (float32 or bfloat16, contiguous,
    ``d <= 128``) or raise; CPU tensors run
    :func:`attention_forward_plain`."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v, sm_scale, causal, offsets,
                                       window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    _check(q, k, v, causal, window, offsets)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"the flash kernel takes float32 or bfloat16, not {q.dtype}"
        )
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q_off, k_off = (int(o) for o in offsets) if offsets is not None else (0, 0)
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    lib = kernels.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.egt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, skv, d, float(sm_scale),
            int(causal), int(window or 0), q_off, k_off,
            _KERNEL_DTYPES[q.dtype], stream,
        )
    kernels.check(err, "egt_flash_fwd")
    global launches
    launches += 1
    return out, lse
