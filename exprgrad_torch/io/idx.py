"""IDX dataset format (MNIST-style) loader/saver.

Parity: reference exprgrad/io/idxformat.nim:19-93.  Big-endian dims and
payload, dtype tag byte per the IDX spec.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from ..errors import ModelRuntimeError

_DTYPES = {
    0x08: np.dtype(">u1"),
    0x09: np.dtype(">i1"),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}
_TAGS = {np.dtype(d.newbyteorder("=")): tag for tag, d in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_idx(path: str) -> np.ndarray:
    """Load an IDX file (transparently handles .gz)."""
    with _open(path, "rb") as f:
        header = f.read(4)
        if len(header) != 4 or header[0] != 0 or header[1] != 0:
            raise ModelRuntimeError(f"{path} is not an IDX file")
        tag, ndim = header[2], header[3]
        if tag not in _DTYPES:
            raise ModelRuntimeError(f"unknown IDX dtype tag 0x{tag:02x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        count = int(np.prod(dims, dtype=np.int64))
        data = np.frombuffer(f.read(), dtype=_DTYPES[tag], count=count)
    return data.astype(_DTYPES[tag].newbyteorder("=")).reshape(dims)


def save_idx(arr: np.ndarray, path: str) -> None:
    arr = np.ascontiguousarray(arr)
    tag = _TAGS.get(arr.dtype)
    if tag is None:
        raise ModelRuntimeError(f"dtype {arr.dtype} is not IDX-serializable")
    with _open(path, "wb") as f:
        f.write(bytes([0, 0, tag, arr.ndim]))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(_DTYPES[tag]).tobytes())
