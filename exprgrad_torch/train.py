"""Multi-epoch training driver of the port: validation, early stopping,
history.

Counterpart of ``exprgrad_tpu/train.py``.  ``evaluate`` and
``classification_accuracy`` read model outputs, which the port returns
as numpy arrays as the JAX package does, so they are the JAX package's
own.  :func:`train` keeps its best state as clones on the model's
device, where the JAX package copies it to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

from exprgrad_tpu.errors import ModelRuntimeError
from exprgrad_tpu.train import classification_accuracy, evaluate

__all__ = ["classification_accuracy", "evaluate", "train"]


def train(
    model,
    target_name: str,
    args: dict,
    epochs: int,
    batch_size: int = 32,
    validation: Optional[dict] = None,
    monitor: str = "loss",
    patience: Optional[int] = None,
    min_delta: float = 0.0,
    restore_best: bool = True,
    shuffle: bool = True,
    scan_batches: bool = False,
    log: Optional[Callable[[str], None]] = None,
    checkpoint=None,
    mesh=None,
    **fit_kw,
) -> list[dict]:
    """Train for up to ``epochs`` epochs; returns the metrics history.

    Each entry: ``{"epoch", "train_<monitor>", "val_<monitor>"?}``.
    ``validation`` holds held-out inputs for the ``monitor`` target
    (evaluated after every epoch); with ``patience`` set, training
    stops after that many epochs without a ``min_delta`` improvement
    of the validation metric, and ``restore_best=True`` puts the
    best-epoch parameters/optimizer state back on the model.  Other
    keywords go to ``Model.fit``.

    ``checkpoint`` (an ``io.CheckpointManager``) and ``mesh`` (sharded
    training) are not ported yet and raise; save checkpoints with
    :func:`exprgrad_torch.io.save_model` between calls.
    """
    if checkpoint is not None:
        raise NotImplementedError(
            "train(checkpoint=...) is not ported to exprgrad_torch yet "
            "(ROADMAP.md A4); save with exprgrad_torch.io.save_model"
        )
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...) is not ported to exprgrad_torch yet "
            "(ROADMAP.md A14: parallelism)"
        )
    if monitor not in model.program.targets:
        raise ModelRuntimeError(
            f"monitor target {monitor!r} is not a target of the model"
        )
    if patience is not None and patience < 1:
        raise ModelRuntimeError("patience must be >= 1")
    if patience is not None and validation is None:
        raise ModelRuntimeError(
            "early stopping (patience) requires a validation set"
        )

    history: list[dict] = []
    best = float("inf")
    best_state = None
    stale = 0
    for _ in range(epochs):
        train_metric = model.fit(
            target_name, args, batch_size=batch_size, log_status=False,
            shuffle=shuffle, scan_batches=scan_batches, monitor=monitor,
            **fit_kw,
        )
        entry = {"epoch": model.epoch,
                 f"train_{monitor}": float(train_metric)}
        if validation is not None:
            val = evaluate(model, monitor, validation)
            entry[f"val_{monitor}"] = val
            if val < best - min_delta:
                best = val
                stale = 0
                if restore_best:
                    best_state = (
                        {t: v.clone() for t, v in model.params.items()},
                        {t: v.clone() for t, v in model.caches.items()},
                        model.epoch,
                    )
            else:
                stale += 1
        history.append(entry)
        if log is not None:
            log(", ".join(f"{k}={v:.5g}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in entry.items()))
        if patience is not None and stale >= patience:
            break
    if restore_best and best_state is not None:
        params, caches, epoch_at = best_state
        model.params.update(params)
        model.caches.update(caches)
        model.epoch = epoch_at
    return history
