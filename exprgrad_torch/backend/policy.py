"""Cost-model routing of user schedules: the hand-written kernel or the
plain lowering.

Counterpart of ``exprgrad_tpu/backend/policy.py``.  A schedule is a
routed hint:

* ``schedule_mode="auto"`` (default): a scheduled kernel runs its kernel
  (a contraction B1, any other map/reduce kernel the generated B5, a run
  of them over one loop nest the fused row chain B6) only where this
  cost model predicts that it wins; elsewhere it runs the port's plain
  lowering (the einsum, ``torch.matmul`` or the per-kernel torch ops),
  with a ``ScheduleWarning`` and a ``schedule-fallback`` stat.
* ``schedule_mode="force"``: always honor a schedule a classifier
  accepts (kernel development, benchmarks); never falls back.
* ``schedule_mode="ignore"``: never run the kernel for a schedule.

Attention's ``impl="auto"`` asks :meth:`SchedulePolicy.attention` in
every mode, as in the JAX package: ``force``/``ignore`` apply to schedule
hints, while ``impl="flash"``/``"xla"`` on the layer are the overrides.

The constants are measured on the card by ``scripts/calibrate_torch.py``
through the compiled executor, the path user models take, and written
to ``calibration.json`` beside this module, which :func:`_load_constants`
merges over :data:`_DEFAULTS` key by key.  The defaults are the same
measurements, each with its card, power limit and run.

Where the form differs from the JAX package's model:

* Names: the constants and the reasons say "kernel" and "plain" where the
  JAX package's say "pallas" and "xla"; ``Decision.use_pallas`` keeps
  its name, so both packages' decisions compare field by field.

* Each side pays its own measured per-call cost.  The JAX model charges a
  launch on the Pallas side only, because XLA fuses the plain path into
  the one jit; here the plain lowering runs one or more eager torch ops
  per kernel, so it has a per-call cost too (``plain_launch_us``,
  ``matmul_plain_launch_us``, ``attention_plain_launch_us``), and a row
  chain's plain path pays it once per member.  The kernel side's costs
  are ``kernel_launch_us`` (B5, B6), ``matmul_kernel_launch_us`` (B1) and
  ``attention_flash_launch_us`` (B2-B4).
* The contraction rates are keyed by compute dtype
  (``*_matmul_tflops_float32``: B1 at split TF32 against ``torch.matmul``
  in float32; ``*_bfloat16``): :meth:`contraction` takes an optional
  ``dtype``, as :meth:`attention` takes ``itemsize``.  Other dtypes use
  the float32 rates.
* A call's cost is its host cost plus its device work, the JAX
  package's form.  Each rate is a large case's work over its wall time a
  call, so it stays below the card's peak, and the model charges a large
  case its per-call cost on top of that wall.
* ``mapreduce``'s ``work_bytes`` (computed-index kernels, V candidates a
  position; the JAX package's ``gather_work`` count, in bytes) is charged
  to the kernel side only where the constants give ``kernel_work_gbps``,
  as the JAX package charges its Pallas side at its elementwise rate.
  The port's calibration gives none: B5 does not compare V candidates a
  position (a gather loads from its computed address; a scatter sorts
  its keys and walks each destination's segment), and the plain
  lowering's ``index_put_`` does not either, so neither side's time
  follows positions x V (the calibration's scatter-add at three V).
  The byte counts themselves are the JAX package's
  (``backend/mapreduce.py``, ``backend/rowchain.py``).
"""

from __future__ import annotations

import functools
import json
import os
import warnings
from dataclasses import dataclass

from ..errors import ScheduleWarning

_MODES = ("auto", "force", "ignore")

# calibrate_torch: begin (scripts/calibrate_torch.py writes this block and
# calibration.json from one run)
# NVIDIA H100 80GB HBM3, 700.00 W; torch 2.11.0+cu128, CUDA 12.8,
# 2026-10-18; median of 5 wall times of back-to-back executor calls (the
# table in PERF.md between the calibrate_torch markers).
_DEFAULTS = {
    # B1 at 4096^3 through the executor (schedule tile 128) against the
    # plain lowering (the einsum: torch.matmul, TF32 off): 2 m n k over the
    # wall time a call; where the two tie, the plain side has the kernel's
    # rate
    "kernel_matmul_tflops_float32": 50.95962866817247,
    "plain_matmul_tflops_float32": 50.95962866817247,
    "kernel_matmul_tflops_bfloat16": 158.11854743143468,
    "plain_matmul_tflops_bfloat16": 612.7087691890275,
    # an elementwise map over 8192 x 8192 float32: the bytes read and
    # written over the wall time a call, B5 and the plain lowering
    "kernel_elementwise_gbps": 2028.8581659911968,
    "plain_elementwise_gbps": 716.4494986017372,
    # the three-kernel softmax at 8192^2 float32 as one B6: its operand and
    # output bytes over the wall time a call
    "kernel_rowchain_gbps": 1996.4905339665493,
    # causal attention [2, 4, 4096, 128] float32 through the attention
    # extern: 4 b h sq skv d over the wall time a call, B2 against
    # impl="xla"
    "flash_attention_tflops": 53.034889321421545,
    "plain_attention_tflops": 15.19354111193404,
    # the per-call cost of a tiny kernel through the executor, the card
    # idle (us a call): a [16, 64] map (B5 / plain), a 64^3 contraction (B1
    # / plain), attention [1, 1, 64, 64] (B2 / impl="xla")
    "kernel_launch_us": 24.823444999952926,
    "plain_launch_us": 129.8853750000717,
    "matmul_kernel_launch_us": 52.790175000012596,
    "matmul_plain_launch_us": 74.79177999996978,
    "attention_flash_launch_us": 67.47434499999372,
    "attention_plain_launch_us": 499.9939642859528,
}
# calibrate_torch: end

_CALIBRATION_PATH = os.path.join(os.path.dirname(__file__),
                                 "calibration.json")

# the compute dtypes the contraction rates are keyed by
_RATE_DTYPES = ("float32", "bfloat16")


@functools.lru_cache(maxsize=None)
def _read(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_constants(path: str = _CALIBRATION_PATH) -> dict:
    """:data:`_DEFAULTS` with ``path``'s measurements merged over them key
    by key; ``calibrated`` says whether the file was read, ``card`` names
    the card it was measured on.  The file is read once a process."""
    constants = dict(_DEFAULTS)
    data = _read(path)
    if data is None:
        constants["calibrated"] = False
        constants["card"] = None
        return constants
    constants.update(
        {k: float(v) for k, v in data.items() if k in _DEFAULTS})
    constants["calibrated"] = True
    constants["card"] = str(data.get("card", "?"))
    return constants


@dataclass
class Decision:
    use_pallas: bool  # the kernel (the JAX package's name for it)
    reason: str


class SchedulePolicy:
    """Routing decisions and fallback reporting for one compiled model."""

    def __init__(self, mode: str = "auto") -> None:
        if mode not in _MODES:
            raise ValueError(
                f"schedule_mode must be one of {_MODES}, got {mode!r}"
            )
        self.mode = mode
        self.constants = _load_constants()

    @property
    def routes_schedules(self) -> bool:
        """Whether schedules may reach the kernels at all (not under
        ``ignore``)."""
        return self.mode != "ignore"

    def _short_cut(self):
        if self.mode == "force":
            return Decision(True, "schedule_mode=force")
        if self.mode == "ignore":
            return Decision(False, "schedule_mode=ignore")
        return None

    def _suffix(self) -> str:
        return "" if self.constants["calibrated"] else \
            " (uncalibrated defaults)"

    @staticmethod
    def _cost(launch_us: float, busy_s: float) -> float:
        """A call's seconds: its host cost plus its device work."""
        return launch_us * 1e-6 + busy_s

    def _rate(self, key: str, dtype) -> float:
        name = str(dtype or "float32").replace("torch.", "")
        if name not in _RATE_DTYPES:
            name = "float32"
        return self.constants[f"{key}_{name}"]

    # -- decisions -------------------------------------------------------
    def contraction(self, m: int, n: int, k: int,
                    dtype="float32") -> Decision:
        """Scheduled matmul-family kernel: B1 against the plain lowering's
        ``torch.matmul``, at the rates of compute ``dtype``.

        As in the JAX package, epilogue fusion does not change the
        decision: neither side is credited the consumer's bytes."""
        short = self._short_cut()
        if short is not None:
            return short
        c = self.constants
        flops = 2.0 * m * n * k
        plain_s = self._cost(
            c["matmul_plain_launch_us"],
            flops / (self._rate("plain_matmul_tflops", dtype) * 1e12))
        kernel_s = self._cost(
            c["matmul_kernel_launch_us"],
            flops / (self._rate("kernel_matmul_tflops", dtype) * 1e12))
        if kernel_s < plain_s:
            return Decision(
                True,
                f"cost model: kernel {kernel_s * 1e6:.0f}us < plain "
                f"{plain_s * 1e6:.0f}us",
            )
        return Decision(
            False,
            f"cost model: plain matmul {plain_s * 1e6:.0f}us <= kernel "
            f"{kernel_s * 1e6:.0f}us" + self._suffix(),
        )

    def mapreduce(self, total_bytes: int, work_bytes: int = 0) -> Decision:
        """Scheduled elementwise/reduction kernel: B5 against the plain
        lowering.  Both sides are bandwidth-bound; ``work_bytes`` charges
        the kernel side for in-kernel element touches beyond the memory
        traffic (computed-index kernels: V candidates a position) where
        the constants give ``kernel_work_gbps``, as the JAX package
        charges its Pallas side; the port's calibration gives none."""
        short = self._short_cut()
        if short is not None:
            return short
        c = self.constants
        plain_s = self._cost(
            c["plain_launch_us"],
            total_bytes / (c["plain_elementwise_gbps"] * 1e9))
        work_s = 0.0
        if c.get("kernel_work_gbps"):
            work_s = work_bytes / (c["kernel_work_gbps"] * 1e9)
        kernel_s = self._cost(
            c["kernel_launch_us"],
            total_bytes / (c["kernel_elementwise_gbps"] * 1e9) + work_s)
        if kernel_s < plain_s:
            return Decision(True, "cost model: kernel bandwidth win")
        return Decision(
            False,
            "cost model: the plain lowering wins for elementwise/reduction"
            + self._suffix(),
        )

    def rowchain(self, operand_bytes: int, out_bytes: int,
                 n_members: int) -> Decision:
        """Fused row chain B6 against its members on the plain lowering,
        each of which reads the chain's operands again and pays its own
        per-call cost; the fused kernel reads them once."""
        short = self._short_cut()
        if short is not None:
            return short
        c = self.constants
        plain_s = self._cost(
            n_members * c["plain_launch_us"],
            (operand_bytes * n_members + out_bytes)
            / (c["plain_elementwise_gbps"] * 1e9))
        kernel_s = self._cost(
            c["kernel_launch_us"],
            (operand_bytes + out_bytes) / (c["kernel_rowchain_gbps"] * 1e9))
        if kernel_s < plain_s:
            return Decision(
                True,
                f"cost model: fused chain {kernel_s * 1e6:.0f}us < "
                f"{n_members}-kernel plain {plain_s * 1e6:.0f}us",
            )
        return Decision(
            False,
            "cost model: the plain per-kernel path wins for this chain"
            + self._suffix(),
        )

    def attention(self, b: int, h: int, sq: int, skv: int, d: int,
                  itemsize: int = 4) -> Decision:
        """Flash attention (B2-B4) against the plain attention
        (``impl="xla"``, which materializes the [sq, skv] weights).

        Independent of ``schedule_mode``.  Where the float32 weights alone
        would pass 2 GB, flash is chosen whatever the rates: the plain
        path would exhaust memory.  ``itemsize`` is taken as the JAX
        package takes it; the weights are float32 on both paths."""
        c = self.constants
        flops = 4.0 * b * h * sq * skv * d
        s2_bytes = 4.0 * b * h * sq * skv  # scores kept float32
        if s2_bytes > 2e9:
            return Decision(True, "weight matrix too large for the plain "
                                  "path")
        plain_s = self._cost(c["attention_plain_launch_us"],
                             flops / (c["plain_attention_tflops"] * 1e12))
        flash_s = self._cost(c["attention_flash_launch_us"],
                             flops / (c["flash_attention_tflops"] * 1e12))
        if flash_s < plain_s:
            return Decision(
                True,
                f"cost model: flash {flash_s * 1e6:.0f}us < plain "
                f"{plain_s * 1e6:.0f}us",
            )
        return Decision(
            False,
            f"cost model: plain attention {plain_s * 1e6:.0f}us <= flash "
            f"{flash_s * 1e6:.0f}us" + self._suffix(),
        )

    # -- reporting ---------------------------------------------------------
    def fallback(self, stats: dict | None, kernel_desc: str, reason: str,
                 kind: str = "schedule-fallback") -> None:
        """Record and warn that a schedule fell back to the plain
        lowering."""
        if stats is not None:
            stats[kind] = stats.get(kind, 0) + 1
        warnings.warn(
            f"schedule on {kernel_desc} not routed to a kernel: {reason} "
            "(compile with schedule_mode='ignore' to silence)",
            ScheduleWarning,
            stacklevel=2,
        )
