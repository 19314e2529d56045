"""Build and bind the port's CUDA kernels (``exprgrad_torch/csrc/*.cu``).

The counterpart of ``exprgrad_tpu/utils/native.py``, for device code:
the sources are compiled with ``nvcc`` by hand into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/exprgrad_torch/`` at the repository root, named by a hash of the
sources and flags, so a second process (or a second call) reuses it.

Nothing here falls back: a missing ``nvcc`` or a failed build raises
with the compiler's output.  Every C entry point returns
``cudaGetLastError()`` after its launch and :func:`check` raises when
that is not 0 — a refused launch never runs, and a later synchronize
would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "exprgrad_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every entry point returns a cudaError_t as int)
_SIGNATURES = {
    # q, k, v, out, lse, b, h, hkv, sq, skv, d, scale, causal, window,
    # q_off, k_off, dtype, stream
    "egt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.c_float, _I, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin); the port's "
        "CUDA kernels are built from exprgrad_torch/csrc at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libegt_kernels_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    # build under a temporary name, then rename: a concurrent process
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{build_log}"
        )
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once per process."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
