"""Rotating checkpoint management: save every N epochs, keep K, resume.

The port's copy of ``exprgrad_tpu/io/manager.py`` in single-file mode:
numbered ``step_<n>.egt`` checkpoints written by
:func:`~exprgrad_torch.io.serialize.save_model` (the JAX package's format,
so either package reads the other's), the most recent ``keep`` kept, and
``restore`` loading onto a device.  ``train(..., checkpoint=mgr,
checkpoint_every=N)`` drives it.  Sharded directories are not ported
(ROADMAP.md A14: parallelism).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from ..errors import ModelRuntimeError

_STEP_RE = re.compile(r"^step_(\d+)\.egt$")


class CheckpointManager:
    """Numbered single-file checkpoints under one directory with bounded
    retention.

    Resume determinism: params, optimizer caches, the epoch counter AND
    the host RNG stream (shuffle order, per-call seeds) all restore, so a
    resumed run trains to the same state as an uninterrupted one.
    """

    def __init__(self, directory: str, keep: int = 3,
                 sharded: bool = False) -> None:
        if sharded:
            raise NotImplementedError(
                "CheckpointManager(sharded=True) is not ported to "
                "exprgrad_torch yet (ROADMAP.md A14: parallelism)"
            )
        if keep < 1:
            raise ModelRuntimeError("CheckpointManager keep must be >= 1")
        self.directory = directory
        self.keep = keep
        self.sharded = False
        os.makedirs(directory, exist_ok=True)

    # -- discovery ------------------------------------------------------

    def steps(self) -> list[int]:
        """Completed checkpoint steps, ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m is not None and os.path.isfile(
                    os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.egt")

    # -- save -----------------------------------------------------------

    def save(self, model, step: Optional[int] = None,
             async_save: bool = False) -> None:
        """Checkpoint ``model`` as ``step`` (default ``model.epoch``), then
        prune beyond ``keep``."""
        if async_save:
            raise ModelRuntimeError(
                "async_save requires sharded=True (single-file saves "
                "gather to the host synchronously anyway)"
            )
        from .serialize import save_model

        if step is None:
            step = int(model.epoch)
        save_model(model, self.path(step))
        self._prune()

    def wait(self) -> None:
        """Single-file saves are synchronous: nothing is in flight."""

    def _prune(self) -> None:
        done = self.steps()
        for step in done[: max(0, len(done) - self.keep)]:
            os.remove(self.path(step))

    # -- restore --------------------------------------------------------

    def restore(self, model=None, step: Optional[int] = None, mesh=None,
                device="cuda"):
        """Load a checkpoint onto ``device``; returns the restored model.

        ``step=None`` restores the latest.  A fresh model is loaded
        (``model`` is ignored, as in the JAX package's single-file mode);
        ``mesh`` raises (ROADMAP.md A14)."""
        if mesh is not None:
            raise NotImplementedError(
                "CheckpointManager.restore(mesh=...) is not ported to "
                "exprgrad_torch yet (ROADMAP.md A14: parallelism)"
            )
        if step is None:
            step = self.latest()
            if step is None:
                raise ModelRuntimeError(
                    f"no checkpoints under {self.directory}"
                )
        if step not in self.steps():
            raise ModelRuntimeError(
                f"checkpoint step {step} not found under {self.directory}"
            )
        from .serialize import load_model

        return load_model(self.path(step), device=device)
