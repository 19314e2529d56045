"""Built-in extern ops of the port: fused attention (forward + backward),
and on import of this module the MoE (``ops/moe.py``) and recurrent
(``ops/recurrent.py``) ops, so that ``registry.get_extern`` finds every
built-in on its one lazy import.

Counterpart of ``exprgrad_tpu/ops/externs.py``.  ``attention`` and
``attention_grad`` carry two implementations behind their ``impl``
attribute:

* ``"flash"`` — the flash-attention kernels of ``ops/attention.py``
  (forward; dq and dkv): the CUDA kernels on the card, their plain
  versions on the CPU.
* ``"xla"``   — :func:`~.attention.attention_forward_plain` and
  :func:`~.attention.attention_backward_plain`, plain torch attention
  that materializes the weights, as the JAX package's non-kernel path
  does (on any device).  Taken only when asked for.
* ``"auto"``  — the policy's choice
  (:meth:`~exprgrad_torch.backend.policy.SchedulePolicy.attention`), the
  cost model measured on the card by ``scripts/calibrate_torch.py``, as
  the JAX package asks its own.  The JAX package also sends shapes that
  miss its TPU kernels' block divisibility (``_flash_ok``) to ``xla``;
  the CUDA kernels tile with bounds checks and take any sequence length,
  so that rule is not carried over.  On the card a shape the kernel
  cannot take (head_dim > 128, a dtype other than float32/bfloat16)
  raises instead of running the plain path.

The forward returns ``(out, lse [b*h, sq])``, the backward
``(dq, dk, dv)``; they record the same ``attention-impl:*`` and
``attention-grad-impl:*`` lowering stats as the JAX package.  Each op runs
once per target run: the executor's extern memo hands its outputs to the
kernels that read them.
"""

from __future__ import annotations

import math

from ..registry import register_extern
from .attention import (attention_backward_plain, attention_forward_plain,
                        flash_attention_backward, flash_attention_forward)


def _scale(attrs: dict, d: int) -> float:
    scale = float(attrs.get("scale", 0.0))
    return scale if scale > 0.0 else 1.0 / math.sqrt(d)


def _window(attrs: dict):
    """Sliding-window size; attr 0 (the serializable encoding) = None."""
    w = int(attrs.get("window", 0))
    return w if w > 0 else None


def _pick_impl(attrs: dict, shapes, ctx) -> str:
    """The impl to run: the attribute, or under ``"auto"`` the policy's
    decision for ``shapes`` (q's ``[b, h, sq, d]``, then k's), as the JAX
    package's ``_pick_impl``.  Its ``_flash_ok`` (the TPU kernels' block
    divisibility) is not carried over: the CUDA kernels take any
    sequence length."""
    impl = attrs.get("impl", "auto")
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl != "auto":
        return impl
    b, h, sq, d = shapes[0]
    skv = shapes[1][2]
    policy = getattr(ctx, "policy", None)
    if policy is None:
        from ..backend.policy import SchedulePolicy

        policy = SchedulePolicy("auto")
    return "flash" if policy.attention(b, h, sq, skv, d).use_pallas else "xla"


def _attention(args, attrs, ctx):
    q, k, v = (a.contiguous() for a in args)
    scale = _scale(attrs, q.shape[-1])
    causal = bool(attrs.get("causal", False))
    window = _window(attrs)
    impl = _pick_impl(attrs, [a.shape for a in args], ctx)
    if ctx is not None:
        ctx.record(f"attention-impl:{impl}")
    if impl == "flash":
        return flash_attention_forward(q, k, v, scale, causal,
                                       window=window)
    return attention_forward_plain(q, k, v, scale, causal, window=window)


def _attention_grad(args, attrs, ctx):
    q, k, v, out, lse, g = (a.contiguous() for a in args)
    scale = _scale(attrs, q.shape[-1])
    causal = bool(attrs.get("causal", False))
    window = _window(attrs)
    impl = _pick_impl(attrs, [a.shape for a in args[:3]], ctx)
    if ctx is not None:
        ctx.record(f"attention-grad-impl:{impl}")
    if impl == "flash":
        return flash_attention_backward(q, k, v, out, lse, g, scale, causal,
                                        window=window)
    return attention_backward_plain(q, k, v, out, lse, g, scale, causal,
                                    window=window)


register_extern("attention", 2, _attention)
register_extern("attention_grad", 3, _attention_grad)

from . import moe as _moe  # noqa: E402,F401  (registers moe/moe_grad)
from . import recurrent as _recurrent  # noqa: E402,F401  (lstm/gru/rnn)
