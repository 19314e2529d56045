"""Split TF32 ("3xTF32") arithmetic, emulated on the CPU.

The port's tensor-core kernels (``csrc/tf32x3.cuh``, used by B1
``csrc/matmul.cu`` and B2 ``csrc/flash_fwd.cu``) compute a float32
product as three TF32 products: each operand ``x`` is split into
``big = rna(x)`` and ``small = rna(x - big)`` (``cvt.rna.tf32.f32``,
round to nearest, ties away from zero) and ``a * b`` becomes
``a.small * b.big + a.big * b.small + a.big * b.big``, summed in float32.
A TF32 value keeps 10 of float32's 23 mantissa bits; a product of two
is exact in float32, so the error is the split's, about 2^-22 per part.

This module repeats that arithmetic with integer operations on the
float32 bits, so that the CPU tests can show which ways of splitting
stay inside ``chip_smoke.py``'s float32 tolerances
(``tests/test_torch_tf32x3.py``).  The kernels do not use it.

Splits (:func:`split`):

* ``"rna"``: the kernels' split.
* ``"mismatched"``: the trap: the raw float32 ``x`` fed to the MMA as
  ``big``, which the tensor core cuts to TF32 by truncation, while
  ``small = x - rna(x)`` was taken against the rounded value.  Where
  ``rna`` rounded up, the sum misses a TF32 step (about 2^-11).
* ``"rz"``: both parts cut by truncation, consistently.
"""

from __future__ import annotations

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


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass (inputs rounded to nearest), summed in
    float32: what TF32 tensor cores give without the split."""
    return tf32_round(a) @ tf32_round(b)
