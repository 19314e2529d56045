"""Routing of user schedules: the hand-written kernel or the plain lowering.

Counterpart of ``exprgrad_tpu/backend/policy.py`` for the modes and the
fallback report:

* ``schedule_mode="auto"`` (default): a scheduled kernel that a
  classifier accepts runs its kernel: a contraction kernel B1, any other
  map/reduce kernel the generated kernel B5, a run of them over one loop
  nest the fused row chain B6.  The JAX package decides ``auto`` with a
  cost model calibrated on the TPU (``pallas_calibration.json``: launch
  time, matmul and elementwise rates, the row chain's bandwidth); those
  constants are TPU measurements and are not ported, so here ``auto``
  takes the kernel whenever the classifier accepts.  A cost model
  measured on the H100 waits for ROADMAP.md A6.
* ``schedule_mode="force"``: always honor a schedule a classifier
  accepts.
* ``schedule_mode="ignore"``: never run the kernel for a schedule.

A schedule that ends on a plain path is reported (``ScheduleWarning`` and
a ``schedule-fallback`` stat), never ignored silently.
"""

from __future__ import annotations

import warnings

from ..errors import ScheduleWarning

_MODES = ("auto", "force", "ignore")


class SchedulePolicy:
    """Routing decisions and fallback reporting for one compiled model."""

    def __init__(self, mode: str = "auto") -> None:
        if mode not in _MODES:
            raise ValueError(
                f"schedule_mode must be one of {_MODES}, got {mode!r}"
            )
        self.mode = mode

    @property
    def routes_schedules(self) -> bool:
        """Whether schedules reach the kernels at all: under ``auto`` and
        ``force`` every kernel a classifier accepts runs its kernel (B1,
        B5, or B6 for a row chain)."""
        return self.mode != "ignore"

    def fallback(self, stats: dict | None, kernel_desc: str,
                 reason: str) -> None:
        """Record and warn that a schedule fell back to the plain
        lowering."""
        if stats is not None:
            stats["schedule-fallback"] = stats.get("schedule-fallback", 0) + 1
        warnings.warn(
            f"schedule on {kernel_desc} not routed to a kernel: {reason} "
            "(compile with schedule_mode='ignore' to silence)",
            ScheduleWarning,
            stacklevel=2,
        )
