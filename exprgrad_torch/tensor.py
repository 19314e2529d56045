"""Host-side tensor utilities.

The reference ships its own small CPU tensor library aimed at dataset
preprocessing (exprgrad/tensors.nim).  Here host tensors are numpy arrays;
``Tensor`` provides the same constructors/utilities on top (new, rand,
linspace, one_hot, remap, view_first, select_random_samples, ...).  Device
tensors are torch tensors managed by the model runtime.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Tensor:
    """Namespace of constructors; all functions return plain numpy arrays."""

    @staticmethod
    def new(shape: Sequence[int], values=None, dtype=np.float32) -> np.ndarray:
        """Tensor.new([2,3], [1,2,3,4,5,6]) or Tensor.new([2,3], 1.0)."""
        if values is None:
            return np.zeros(shape, dtype=dtype)
        arr = np.asarray(values, dtype=dtype)
        if arr.ndim == 0:
            return np.full(shape, arr, dtype=dtype)
        return arr.reshape(shape)

    @staticmethod
    def zeros(shape: Sequence[int], dtype=np.float32) -> np.ndarray:
        return np.zeros(shape, dtype=dtype)

    @staticmethod
    def rand(
        shape: Sequence[int],
        lo: float = 0.0,
        hi: float = 1.0,
        dtype=np.float32,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return rng.uniform(lo, hi, size=tuple(shape)).astype(dtype)

    @staticmethod
    def linspace(lo: float, hi: float, count: int, dtype=np.float32) -> np.ndarray:
        return np.linspace(lo, hi, count, dtype=dtype)


def one_hot(labels: np.ndarray, count: int, dtype=np.float32) -> np.ndarray:
    """[N] int labels -> [N, count] one-hot (reference tensors.nim:273)."""
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    out = np.zeros((labels.shape[0], count), dtype=dtype)
    out[np.arange(labels.shape[0]), labels] = 1
    return out


def remap(x: np.ndarray, from_lo, from_hi, to_lo, to_hi) -> np.ndarray:
    """Linear range remap (reference tensors.nim remap)."""
    x = np.asarray(x, dtype=np.float32)
    scale = (to_hi - to_lo) / (from_hi - from_lo)
    return (x - from_lo) * scale + to_lo


def view_first(x: np.ndarray, offset: int, count: int) -> np.ndarray:
    """Zero-copy view of ``count`` samples starting at ``offset``
    (reference tensors.nim:290-300)."""
    return x[offset : offset + count]


def select_samples(x: np.ndarray, indices: Sequence[int]) -> np.ndarray:
    return x[np.asarray(indices, dtype=np.int64)]


def select_random_samples(
    x: np.ndarray, count: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return x[rng.integers(0, x.shape[0], size=count)]


def shuffle_xy(
    x: np.ndarray, y: np.ndarray, rng: Optional[np.random.Generator] = None
) -> tuple[np.ndarray, np.ndarray]:
    rng = rng or np.random.default_rng()
    perm = rng.permutation(x.shape[0])
    return x[perm], y[perm]


def concat_first(*tensors: np.ndarray) -> np.ndarray:
    return np.concatenate(tensors, axis=0)


def squares(x: np.ndarray) -> np.ndarray:
    return np.square(x)
