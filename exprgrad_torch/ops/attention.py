"""Flash attention: the hand-written CUDA kernels and their plain twins.

Counterpart of ``exprgrad_tpu/ops/attention.py``.  The kernels are
``exprgrad_torch/csrc/flash_fwd.cu`` (forward) and
``exprgrad_torch/csrc/flash_bwd.cu`` (backward: dq, then dk/dv).
:func:`flash_attention_forward` and :func:`flash_attention_backward`
launch them for CUDA tensors and raise on anything they cannot take.
For CPU tensors — and only for them — they run
:func:`attention_forward_plain` and :func:`attention_backward_plain`,
straightforward math over the whole score matrix that also serves as the
oracle the kernels are checked against on the card.
:func:`flash_attention` is the differentiable op (``torch.autograd``).

The forward is also the ``torch.library`` op ``exprgrad_torch::flash_fwd``
(CPU: the plain version; CUDA: the kernel; a fake implementation gives
``out`` and ``lse`` their shapes), so ``torch.export`` keeps kernel B2
in an exported program (``Model.export_compiled``).  It is defined with
``Library.define``/``impl`` rather than ``torch.library.custom_op``,
whose Python wrapper costs more host time a call (aliasing checks and
an autograd layer the training path does not use: ``_FlashAttention``
owns the gradient).
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Sequence

import torch

from ..utils import kernels

NEG_INF = -1e30  # the masked-score constant of the TPU kernels

# kernel launches since the last reset (forward, dq, dkv); chip_smoke.py
# reads them to prove the main path ran through the kernels
launches = 0
dq_launches = 0
dkv_launches = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/flash_fwd.cu's FlashFwdArgs: q, k, v, out, lse; b, h, hkv, sq, skv,
# d; scale; causal, window, q_off, k_off, dtype
_FWD_ARGS = struct.Struct("<5Q6if5i")
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


def _kernel_args(tensors: dict, sm_scale, causal, offsets, window):
    """Check what a CUDA kernel takes, or raise; returns the launch sizes
    ``(b, h, sq, d, hkv, skv, sm_scale, q_off, k_off)``.  ``tensors``
    starts with q, k, v; every tensor must share q's device and dtype
    and be contiguous."""
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    dev, dtype = q.device, q.dtype  # read once: a launch is on every path
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {dev}")
    _check(q, k, v, causal, window, offsets)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"the flash kernels take float32 or bfloat16, not {q.dtype}"
        )
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q_off, k_off = (int(o) for o in offsets) if offsets is not None else (0, 0)
    return b, h, sq, d, hkv, skv, float(sm_scale), q_off, k_off


def _launch(entry: str, q: torch.Tensor, *args) -> None:
    """Call a C entry point on q's device and current stream: tensors go
    as data pointers, then q's kernel dtype code and the stream are
    appended; raises if the launch failed."""
    kernels.call(entry, q.device, q.data_ptr(),
                 *[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args],
                 _KERNEL_DTYPES[q.dtype])


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


def _flash_fwd_cuda(q, k, v, sm_scale, causal, offsets, window):
    """The CUDA implementation of ``exprgrad_torch::flash_fwd``: checks
    what the kernel takes, or raises, then launches it."""
    b, h, sq, d, hkv, skv, sm_scale, q_off, k_off = _kernel_args(
        dict(q=q, k=k, v=v), sm_scale, causal, offsets, window)
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    kernels.call("egt_flash_fwd_packed", q.device, _FWD_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, hkv, sq, skv, d, sm_scale, int(causal),
        int(window or 0), q_off, k_off, _KERNEL_DTYPES[q.dtype]))
    global launches
    launches += 1
    return out, lse


def _flash_fwd_fake(q, k, v, sm_scale, causal, offsets, window):
    b, h, sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b * h, sq), dtype=torch.float32))


_LIB = torch.library.Library("exprgrad_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, float? sm_scale, "
            "bool causal, int[]? offsets, int? window) -> (Tensor, Tensor)")
_LIB.impl("flash_fwd", attention_forward_plain, "CPU")
_LIB.impl("flash_fwd", _flash_fwd_cuda, "CUDA")
torch.library.register_fake("exprgrad_torch::flash_fwd", _flash_fwd_fake,
                            lib=_LIB)
# the overload's C++ callable: calling it skips OpOverload.__call__'s
# Python frame, about 2 us of host time a call
_FLASH_FWD = torch.ops.exprgrad_torch.flash_fwd.default._op


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
    :func:`attention_forward_plain`.  Both go through the op
    ``exprgrad_torch::flash_fwd``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for {q.device}")
    return _FLASH_FWD(q, k, v, sm_scale, causal, offsets, window)


def attention_backward_plain(q, k, v, out, lse, g,
                             sm_scale: Optional[float] = None,
                             causal: bool = False,
                             offsets: Optional[Sequence[int]] = None,
                             window: Optional[int] = None):
    """``(dq, dk, dv)`` of attention for the output cotangent ``g`` — the
    plain PyTorch version of the dq and dkv kernels.

    As ``xla_attention_vjp`` in the JAX package, it materializes the
    weights P as the masked softmax over the whole score matrix, in
    float32 (float64 for float64 inputs); ``delta = rowsum(g * out)`` as
    in the kernels.  A row with no live key (``lse = -inf`` from the
    forward) has P = 0: its dq is 0 and it adds nothing to dk or dv.
    Under grouped-query attention dk/dv sum over each kv head's query
    heads."""
    _check(q, k, v, causal, window, offsets)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    qc, kc, vc, oc, gc = (t.to(cdt) for t in (q, k, v, out, g))
    if group > 1:
        kc = kc.repeat_interleave(group, dim=1)
        vc = vc.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * sm_scale
    keep = _keep_mask(sq, skv, causal, window, offsets, q.device)
    p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    live = ~torch.isneginf(lse.reshape(b, h, sq, 1)) & keep
    p = p.masked_fill(~live, 0.0)
    delta = (gc * oc).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gc)
    dp = torch.einsum("bhqd,bhkd->bhqk", gc, vc)
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kc)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qc)
    if group > 1:
        dk = dk.reshape(b, hkv, group, skv, d).sum(dim=2)
        dv = dv.reshape(b, hkv, group, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    """A per-row float32 input of the kernels: [b*h, sq], contiguous."""
    b, h, sq, _ = q.shape
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, not {t.dtype}")
    if tuple(t.shape) != (b * h, sq) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous [{b * h}, {sq}] tensor, not "
            f"{tuple(t.shape)}"
        )


def flash_bwd_dq(q, k, v, out, lse, g, sm_scale: Optional[float] = None,
                 causal: bool = False,
                 offsets: Optional[Sequence[int]] = None,
                 window: Optional[int] = None):
    """Launch the dq kernel on CUDA tensors: ``(dq, delta [b*h, sq])``.
    It also computes ``delta = rowsum(g * out)``, which the dkv kernel
    reads.  Use :func:`flash_attention_backward`; this and
    :func:`flash_bwd_dkv` are its two launches, apart for timing."""
    b, h, sq, d, hkv, skv, sm_scale, q_off, k_off = _kernel_args(
        dict(q=q, k=k, v=v, out=out, g=g), sm_scale, causal, offsets, window)
    _check_rows("lse", lse, q)
    dq = torch.empty_like(q)
    delta = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    _launch("egt_flash_bwd_dq", q, k, v, out, g, lse, delta, dq, b, h, hkv,
            sq, skv, d, sm_scale, int(causal), int(window or 0), q_off,
            k_off)
    global dq_launches
    dq_launches += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, g, sm_scale: Optional[float] = None,
                  causal: bool = False,
                  offsets: Optional[Sequence[int]] = None,
                  window: Optional[int] = None):
    """Launch the dk/dv kernel on CUDA tensors: ``(dk, dv)``, from the
    ``delta`` that :func:`flash_bwd_dq` returned."""
    b, h, sq, d, hkv, skv, sm_scale, q_off, k_off = _kernel_args(
        dict(q=q, k=k, v=v, g=g), sm_scale, causal, offsets, window)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("egt_flash_bwd_dkv", q, k, v, g, lse, delta, dk, dv, b, h, hkv,
            sq, skv, d, sm_scale, int(causal), int(window or 0), q_off,
            k_off)
    global dkv_launches
    dkv_launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, g,
                             sm_scale: Optional[float] = None,
                             causal: bool = False,
                             offsets: Optional[Sequence[int]] = None,
                             window: Optional[int] = None):
    """Flash-attention backward: ``(dq, dk, dv)`` from the forward's saved
    ``(out, lse)`` and the output cotangent ``g`` (``offsets``: the
    ring-attention partial-gradient building block).

    CUDA tensors launch the dq kernel, then the dkv kernel (float32 or
    bfloat16, contiguous, ``d <= 128``, lse float32) or raise; CPU
    tensors run :func:`attention_backward_plain`."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, out, lse, g, sm_scale,
                                        causal, offsets, window)
    dq, delta = flash_bwd_dq(q, k, v, out, lse, g, sm_scale, causal,
                             offsets, window)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, g, sm_scale, causal,
                           offsets, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp`` ``flash_attention``: the
    forward saves ``(q, k, v, out, lse)`` and the backward runs
    :func:`flash_attention_backward` on them."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, offsets, window):
        out, lse = flash_attention_forward(q, k, v, sm_scale, causal,
                                           offsets, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (sm_scale, causal, offsets, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                              g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = False,
                    offsets: Optional[Sequence[int]] = None,
                    window: Optional[int] = None):
    """``softmax(scale * q k^T + mask) v``, differentiable in q, k and v
    through the flash kernels (their plain versions on the CPU)."""
    return _FlashAttention.apply(q, k, v, sm_scale, causal, offsets, window)
