"""Split TF32 ("3xTF32") arithmetic, emulated on the CPU.

The port's tensor-core kernels (``csrc/tf32x3.cuh``, used by B1
``csrc/matmul.cuh`` and ``csrc/gemm_sm90.cu``, B2 ``csrc/flash_fwd.cu``,
B3/B4 ``csrc/flash_bwd.cu`` and the decode step's
``csrc/gemm_skinny_sm90.cu``) compute a float32
product as three TF32 products: each operand ``x`` is split into
``big = rna(x)`` and ``small = rna(x - big)`` (``cvt.rna.tf32.f32``,
round to nearest, ties away from zero) and ``a * b`` becomes
``a.small * b.big + a.big * b.small + a.big * b.big``, summed in float32.
A TF32 value keeps 10 of float32's 23 mantissa bits; a product of two
is exact in float32, so the error is the split's, about 2^-22 per part.

This module repeats that arithmetic with integer operations on the
float32 bits, so that the CPU tests can show which ways of splitting
stay inside ``chip_smoke.py``'s float32 tolerances
(``tests/test_torch_tf32x3.py``); :func:`attention_backward` repeats the
backward kernels' products and the order in which they sum them.  The
kernels do not use it.

Splits (:func:`split`):

* ``"rna"``: the kernels' split.
* ``"mismatched"``: the trap: the raw float32 ``x`` fed to the MMA as
  ``big``, which the tensor core cuts to TF32 by truncation, while
  ``small = x - rna(x)`` was taken against the rounded value.  Where
  ``rna`` rounded up, the sum misses a TF32 step (about 2^-11).
* ``"rz"``: both parts cut by truncation, consistently.
"""

from __future__ import annotations

import math

import torch

_DROPPED = 13  # float32 mantissa bits that TF32 drops (23 - 10)
_KEEP = -(1 << _DROPPED)  # int32 mask: sign, exponent, 10 mantissa bits
SPLITS = ("rna", "mismatched", "rz")


def tf32_round(x: torch.Tensor, mode: str = "rna") -> torch.Tensor:
    """``x`` (float32) at TF32 precision: ``"rna"`` to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), ``"rz"`` toward zero (what the
    tensor core does to a float32 it reads).  Infinities and NaN pass
    through."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    if mode == "rna":
        # float32 is sign and magnitude: adding half of the dropped step to
        # the bits rounds the magnitude, carrying into the exponent
        bits = bits + (1 << (_DROPPED - 1))
    elif mode != "rz":
        raise ValueError(f"unknown rounding {mode!r}")
    out = (bits & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def split(x: torch.Tensor, how: str = "rna") -> tuple:
    """``(big, small)``: the two TF32 values the MMAs read for ``x``."""
    x = x.to(torch.float32)
    if how == "rna":
        big = tf32_round(x, "rna")
        return big, tf32_round(x - big, "rna")
    if how == "mismatched":
        return tf32_round(x, "rz"), tf32_round(x - tf32_round(x, "rna"), "rz")
    if how == "rz":
        big = tf32_round(x, "rz")
        return big, tf32_round(x - big, "rz")
    raise ValueError(f"unknown split {how!r}")


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor,
                  how: str = "rna") -> torch.Tensor:
    """``a @ b`` in split TF32, summed in float32 as the kernels sum it:
    the two small terms first, then big . big (batched like ``@``)."""
    a_big, a_small = split(a, how)
    b_big, b_small = split(b, how)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def kmajor_gemm(a: torch.Tensor, b: torch.Tensor,
                group: int = 32) -> torch.Tensor:
    """``a @ b^T`` of K-major operands ``a`` [batch, m, k] and ``b``
    [batch, n, k] as B1's Hopper mainloop (csrc/gemm_sm90.cu) sums it:
    both split into big and small planes, each ``group``-deep slice of k
    summed into a fresh float32 accumulator (small.big, big.small, then
    big.big) and added to the running float32 sum, slice by slice."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    acc = None
    for k0 in range(0, a.shape[-1], group):
        s = slice(k0, k0 + group)
        part = (a_small[..., s] @ b_big[..., s].transpose(-1, -2)
                + a_big[..., s] @ b_small[..., s].transpose(-1, -2))
        part = part + a_big[..., s] @ b_big[..., s].transpose(-1, -2)
        acc = part if acc is None else acc + part
    return acc


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass (inputs rounded to nearest), summed in
    float32: what TF32 tensor cores give without the split."""
    return tf32_round(a) @ tf32_round(b)


# the backward kernels' shape (csrc/flash_bwd.cu): a warp sums one product
# over its CHUNK rows of a streamed tile (kWarpN), WARPS warps (kSplit)
# share the tile, and their sums are added at the end
CHUNK, WARPS = 16, 4


def _parts(x: torch.Tensor, how: str) -> tuple:
    """The TF32 parts a product reads for ``x``: ``(big, small)`` for
    split TF32, ``(rna(x), None)`` for one TF32 pass."""
    if how == "single":
        return tf32_round(x), None
    return split(x, how)


def _chunk_products(a: tuple, b: tuple, chunk: int) -> torch.Tensor:
    """``a @ b`` summed over each ``chunk`` of k apart: ``[..., k/chunk,
    m, n]``, from the TF32 parts of ``a`` [..., m, k] and ``b``
    [..., k, n]."""
    def rows(x):  # [..., m, k] -> [..., m, c, chunk]
        return None if x is None else x.reshape(*x.shape[:-1], -1, chunk)

    def cols(x):  # [..., k, n] -> [..., c, chunk, n]
        return None if x is None else x.reshape(*x.shape[:-2], -1, chunk,
                                                x.shape[-1])

    (ab, as_), (bb, bs) = tuple(map(rows, a)), tuple(map(cols, b))
    mm = lambda x, y: torch.einsum("...mck,...ckn->...cmn", x, y)  # noqa: E731
    if as_ is None:
        return mm(ab, bb)
    return (mm(as_, bb) + mm(ab, bs)) + mm(ab, bb)


def _warp_sums(parts: torch.Tensor) -> torch.Tensor:
    """Sum ``[..., c, m, n]`` over c as the kernels do: chunk c goes to
    warp ``c % WARPS``, each warp adds its chunks in order in float32, and
    the warps' sums are added in order at the end."""
    acc = [None] * WARPS
    for c in range(parts.shape[-3]):
        w = c % WARPS
        part = parts[..., c, :, :]
        acc[w] = part if acc[w] is None else acc[w] + part
    total = acc[0]
    for part in acc[1:]:
        total = total + part
    return total


def attention_backward(q, k, v, out, lse, g, how: str = "rna"):
    """``(dq, dk, dv)`` of causal attention with every product computed
    as the backward kernels compute it: split TF32 (``how="rna"``) or one
    TF32 pass (``how="single"``), each product's sum taken in float32 over
    one warp's CHUNK rows of a streamed tile at a time, and the chunks
    added in the kernels' order (``_warp_sums``).

    q [b, h, s, d]; k, v [b, hkv, s, d] (grouped-query attention: dk/dv
    sum the group's heads, one after the other); out and lse the
    forward's (lse [b*h, s], -inf for a dead row); g the output
    cotangent.  S and dP (k = d) are single products; P, delta and dS
    are float32 elementwise, as in the kernels."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    q, k, v, out, g = (t.to(torch.float32) for t in (q, k, v, out, g))
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    qp, kp, vp, gp = (_parts(t, how) for t in (q, kr, vr, g))

    def whole(a, bt):  # a @ bt^T in one chunk of k = d
        bt = tuple(None if x is None else x.transpose(-1, -2) for x in bt)
        return _chunk_products(a, bt, d)[..., 0, :, :]

    sc = whole(qp, kp)
    dp = whole(gp, vp)
    lse = lse.reshape(b, h, s, 1).to(torch.float32)
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, math.inf),
                      lse)
    p = torch.exp(sc * scale - lse)
    p = p.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), 0.0)
    delta = (g * out).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = _warp_sums(_chunk_products(_parts(ds, how), kp, CHUNK))
    # dk/dv: the query rows of each head in turn; chunk c of head i is the
    # kernels' turn i * (chunks a head) + c
    pt, dst = (_parts(t.transpose(-1, -2), how) for t in (p, ds))

    def by_group(parts):  # [b, h, c, s, d] -> [b, hkv, group * c, s, d]
        return parts.reshape(b, hkv, -1, *parts.shape[-2:])

    dv = _warp_sums(by_group(_chunk_products(pt, gp, CHUNK)))
    dk = _warp_sums(by_group(_chunk_products(dst, qp, CHUNK)))
    return dq, dk, dv
