"""Checkpoints of port models, in the JAX package's formats.

Counterpart of ``exprgrad_tpu/io/serialize.py``: a checkpoint written by
either package loads in the other.  The port's state is torch tensors on
a device, so each function here copies it to host numpy arrays (or back)
and leaves the file format to the JAX package's readers and writers,
which need no jax.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from exprgrad_tpu.io import serialize as _ref

from ..model import Model, from_reference


def _host_view(model: Model) -> SimpleNamespace:
    """What the JAX package's writers read of a model, on the host."""
    return SimpleNamespace(
        source=model.source, program=model.program, epoch=model.epoch,
        _rng=model._rng,
        params={t: v.cpu().numpy() for t, v in model.params.items()},
        caches={t: v.cpu().numpy() for t, v in model.caches.items()},
    )


def save_model(model: Model, path: str) -> None:
    """Checkpoint = source program + params + caches + epoch + the host
    random stream, as ``exprgrad_tpu.io.save_model`` writes it."""
    _ref.save_model(_host_view(model), path)


def load_model(path: str, device="cuda") -> Model:
    """Reload a checkpoint of either package as a port model on
    ``device``; the program is recompiled."""
    return from_reference(_ref.load_model(path, backend="interp"), device)


def export_params_npz(model: Model, path: str) -> None:
    """Every parameter and cache as a named array in a ``.npz``
    (``exprgrad_tpu.io.export_params_npz``'s names)."""
    _ref.export_params_npz(_host_view(model), path)


def import_params_npz(model: Model, path: str) -> None:
    """Load arrays written by :func:`export_params_npz` (of either
    package) into a model compiled from the same program; shapes must
    match."""
    view = _host_view(model)
    _ref.import_params_npz(view, path)
    model.params = {t: model._to_device(np.asarray(v))
                    for t, v in view.params.items()}
    model.caches = {t: model._to_device(np.asarray(v))
                    for t, v in view.caches.items()}
