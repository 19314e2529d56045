"""Weight-only int8 quantization (W8A16), integrated with the IR.

Counterpart of ``exprgrad_tpu/quant.py``, in two layers:

* the mechanics: :class:`QuantW` (int8 codes and float32 scales),
  :func:`quantize_weight` and :func:`dequantize`.  Symmetric
  per-output-channel scales with the elementwise bound
  ``|w - deq(q(w))| <= scale / 2``.  The codes are what the model keeps;
  a weight is dequantized where it is used (the JAX package has no int8
  matmul kernel either: XLA fuses the convert and scale into the dot).

* the compiler integration: :func:`infer_quant_axes` reads a parameter's
  role off the kernel IR.  A read axis whose iterators all appear in the
  kernel's write index is an output channel (it keeps its own scale); an
  axis indexed by a reduction iterator is contracted (folded into the
  scale's max).  Raw, computed-index (gather) and extern-consumed reads
  decline, so embeddings and custom kernels stay at full precision.
  ``Model.quantize_weights()`` and ``FlashLMServer(weight_dtype=)`` share
  these helpers (``models/_quant.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


class QuantW(NamedTuple):
    """int8 codes and float32 per-output-channel scales."""

    codes: torch.Tensor  # int8, the original weight's shape
    scale: torch.Tensor  # float32, keepdims-reduced over contracted axes


def check_weight_dtype(dtype) -> None:
    """The one place the supported weight dtypes are defined: int8, given
    as ``torch.int8``, ``np.int8`` or ``"int8"``."""
    if isinstance(dtype, torch.dtype):
        ok = dtype == torch.int8
    else:
        try:
            ok = np.dtype(dtype) == np.dtype(np.int8)
        except TypeError:
            ok = False
    if not ok:
        from .errors import ModelRuntimeError

        raise ModelRuntimeError(
            f"unsupported weight dtype {dtype!r} (int8 weight-only "
            "quantization is supported)"
        )


def quantize_weight(w: torch.Tensor,
                    contract_axes: Union[int, Sequence[int]]) -> QuantW:
    """Symmetric int8 quantization with one scale per output channel.

    ``contract_axes`` are the weight axes the matmul sums over; every
    other axis indexes an output channel and keeps its own scale.
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so float32
    weights give the JAX package's codes bit for bit."""
    if isinstance(contract_axes, int):
        contract_axes = (contract_axes,)
    amax = w.abs().amax(dim=tuple(contract_axes), keepdim=True)
    scale = amax.clamp(min=1e-30) / 127.0
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantW(codes, scale.to(torch.float32))


def dequantize(w, dtype: Optional[torch.dtype] = None):
    """Inverse of :func:`quantize_weight` (float32 unless ``dtype``);
    plain tensors pass through, cast to ``dtype`` when given."""
    if isinstance(w, QuantW):
        dtype = dtype or torch.float32
        return w.codes.to(dtype) * w.scale.to(dtype)
    return w if dtype is None else w.to(dtype)


def infer_quant_axes(
    program, tid: int, target_name: str
) -> Optional[tuple[int, ...]]:
    """Contraction axes of parameter ``tid`` in ``target_name``'s kernels.

    Returns the sorted axes that are summed over (per-channel scales go
    on every other axis), or None when per-channel quantization is not
    safely inferable:

    * the parameter is never read in this target, or only elementwise
      (biases, norm gammas: no matmul bandwidth to save);
    * a read is raw (flat ``{i}`` access) or uses computed indices
      (gathers, such as embedding lookups);
    * an extern kernel consumes it.

    An axis whose index registers all appear in the kernel's write index
    enumerates output channels; an axis indexed by any reduction
    iterator is contracted.  Axes are unioned over every read in the
    target, so the scales hold for every kernel that reads it."""
    target = program.targets[target_name]
    contract: set[int] = set()
    seen = False
    for kernel in target.kernels:
        if kernel.extern is not None and tid in kernel.extern.inputs:
            return None
        loop_regs = {loop.iter_reg for loop in kernel.loops}
        write_regs: set[int] = set()
        if kernel.write is not None:
            for d in kernel.write.dims:
                write_regs |= set(d.factors)
        for read in kernel.reads:
            if read.tensor != tid:
                continue
            seen = True
            if read.is_raw:
                return None
            for axis, d in enumerate(read.dims):
                regs = set(d.factors)
                if d.setup or not regs <= loop_regs:
                    return None  # computed index: a gather, not a matmul
                if not regs <= write_regs:
                    contract.add(axis)
    if not seen or not contract:
        return None
    return tuple(sorted(contract))
