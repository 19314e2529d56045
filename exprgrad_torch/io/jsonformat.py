"""JSON IO with tensor support.

Parity: the reference ships a hand-rolled JSON parser (io/jsonformat.nim)
because Nim's stdlib was slow; Python's stdlib json is C-accelerated, so
this module is a thin layer adding numpy-array encoding (nested lists with
dtype/shape preservation for round-trips)."""

from __future__ import annotations

import json
from typing import Any

import numpy as np


class TensorEncoder(json.JSONEncoder):
    def default(self, obj: Any):
        if isinstance(obj, np.ndarray):
            return {
                "__tensor__": True,
                "dtype": obj.dtype.name,
                "shape": list(obj.shape),
                "data": obj.reshape(-1).tolist(),
            }
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        return super().default(obj)


def _decode_hook(obj: dict):
    if obj.get("__tensor__"):
        return np.array(obj["data"], dtype=obj["dtype"]).reshape(obj["shape"])
    return obj


def dumps(value: Any, **kwargs) -> str:
    return json.dumps(value, cls=TensorEncoder, **kwargs)


def loads(text: str) -> Any:
    return json.loads(text, object_hook=_decode_hook)


def save_json(value: Any, path: str, **kwargs) -> None:
    with open(path, "w") as f:
        json.dump(value, f, cls=TensorEncoder, **kwargs)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f, object_hook=_decode_hook)
