"""ctypes bindings for the native data-plumbing library
(``native/egtpu_native.cpp``): dataset normalization, one-hot labels, batch
assembly (``gather_rows``), the epoch shuffle (``shuffle_indices``), CRC-32
and the byte-level BPE merge loop (``bpe_encode``).

Host-side code, not a device kernel: it feeds the batches that
:class:`~exprgrad_torch.io.dataset.Prefetcher` copies to the card.  The
port's copy of ``exprgrad_tpu/utils/native.py``, built from the same C++
source but into ``build/exprgrad_torch/native/`` at the repository root
(never into ``native/``), on first use, with ``g++``.

Where no toolchain is there (or the build fails) each entry point takes
the numpy path the JAX package's copy takes: ``src.astype`` for
``u8_to_f32``, fancy indexing for ``gather_rows``,
``np.random.default_rng(seed).permutation`` for ``shuffle_indices``,
``zlib.crc32``, and ``None`` from ``bpe_encode`` (the tokenizer then runs
its Python merge loop, which gives the same ids).  The permutation of that
path differs from the library's SplitMix64 Fisher-Yates for the same
seed, as it does in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "egtpu_native.cpp"
_BUILD_DIR = _ROOT / "build" / "exprgrad_torch" / "native"
_LIB_PATH = _BUILD_DIR / "libegtpu.so"
_EXPECTED_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile the library into ``build/``; False without a toolchain.
    Each build writes a private file and renames it into place, so
    processes that build at once do not see a half-written library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or not _SOURCE.exists():
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, "-O3", "-march=native", "-funroll-loops", "-shared",
             "-fPIC", "-o", tmp, str(_SOURCE)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.egtpu_version.restype = ctypes.c_int32
        if lib.egtpu_version() != _EXPECTED_VERSION:
            return None
        return lib
    except (OSError, AttributeError):
        return None


def native_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without a toolchain."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _load() if _LIB_PATH.exists() else None
    if lib is None:  # missing or out of date: build once and reload
        if not _build():
            return None
        lib = _load()
    if lib is None:
        return None
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.egtpu_u8_to_f32.argtypes = [
        u8, f32, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
    lib.egtpu_one_hot.argtypes = [i64, f32, ctypes.c_int64, ctypes.c_int64]
    lib.egtpu_gather_rows.argtypes = [
        u8, i64, u8, ctypes.c_int64, ctypes.c_int64]
    lib.egtpu_shuffle_indices.argtypes = [i64, ctypes.c_int64,
                                          ctypes.c_uint64]
    lib.egtpu_crc32.argtypes = [u8, ctypes.c_int64, ctypes.c_uint32]
    lib.egtpu_crc32.restype = ctypes.c_uint32
    lib.egtpu_bpe_encode.argtypes = [
        u8, i64, ctypes.c_int64, i32, i32, ctypes.c_int64, i32]
    lib.egtpu_bpe_encode.restype = ctypes.c_int64
    _lib = lib
    return _lib


def have_native() -> bool:
    return native_lib() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def u8_to_f32(src: np.ndarray, scale: float, bias: float = 0.0) -> np.ndarray:
    """dst = src * scale + bias for u8 images (dataset normalization)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    lib = native_lib()
    if lib is None:
        return src.astype(np.float32) * np.float32(scale) + np.float32(bias)
    dst = np.empty(src.shape, dtype=np.float32)
    lib.egtpu_u8_to_f32(_ptr(src, ctypes.c_uint8), _ptr(dst, ctypes.c_float),
                        src.size, scale, bias)
    return dst


def one_hot_native(labels: np.ndarray, classes: int) -> np.ndarray:
    labels = np.ascontiguousarray(labels, dtype=np.int64).reshape(-1)
    lib = native_lib()
    if lib is None:
        out = np.zeros((labels.size, classes), dtype=np.float32)
        out[np.arange(labels.size), labels] = 1
        return out
    out = np.empty((labels.size, classes), dtype=np.float32)
    lib.egtpu_one_hot(_ptr(labels, ctypes.c_int64),
                      _ptr(out, ctypes.c_float), labels.size, classes)
    return out


def gather_rows(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Batch assembly: out[i] = src[indices[i]], one memcpy per row."""
    src = np.ascontiguousarray(src)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    lib = native_lib()
    if lib is None:
        return src[indices]
    out = np.empty((indices.size,) + src.shape[1:], dtype=src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    lib.egtpu_gather_rows(
        _ptr(src.view(np.uint8), ctypes.c_uint8),
        _ptr(indices, ctypes.c_int64),
        _ptr(out.view(np.uint8), ctypes.c_uint8),
        indices.size, row_bytes)
    return out


def shuffle_indices(count: int, seed: int) -> np.ndarray:
    lib = native_lib()
    if lib is None:
        return np.random.default_rng(seed).permutation(count)
    out = np.empty(count, dtype=np.int64)
    lib.egtpu_shuffle_indices(_ptr(out, ctypes.c_int64), count, seed)
    return out


def crc32(data: bytes, seed: int = 0) -> int:
    lib = native_lib()
    if lib is None:
        import zlib

        return zlib.crc32(data, seed)
    arr = np.frombuffer(data, dtype=np.uint8)
    return int(lib.egtpu_crc32(_ptr(arr, ctypes.c_uint8), arr.size, seed))


def bpe_encode(data: bytes, chunk_offs: np.ndarray, merge_a: np.ndarray,
               merge_b: np.ndarray) -> Optional[np.ndarray]:
    """Byte-level BPE encode of pre-split chunks (``io/tokenizer.py``
    semantics, bit-exact).  Returns int32 token ids, or ``None`` without
    the library (the caller then runs its Python loop)."""
    lib = native_lib()
    if lib is None:
        return None
    if not data:
        return np.zeros(0, np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    offs = np.ascontiguousarray(chunk_offs, dtype=np.int64)
    ma = np.ascontiguousarray(merge_a, dtype=np.int32)
    mb = np.ascontiguousarray(merge_b, dtype=np.int32)
    out = np.empty(buf.size, dtype=np.int32)
    n = lib.egtpu_bpe_encode(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        offs.size - 1, _ptr(ma, ctypes.c_int32), _ptr(mb, ctypes.c_int32),
        ma.size, _ptr(out, ctypes.c_int32))
    return out[:n].copy()
