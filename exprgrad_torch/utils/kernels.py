"""Build and bind the port's CUDA kernels (``exprgrad_torch/csrc/*.cu``).

The counterpart of ``exprgrad_tpu/utils/native.py``, for device code:
the sources are compiled with ``nvcc`` by hand, one process per ``.cu``
file, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every entry point returns a cudaError_t as int)
_SIGNATURES = {
    # q, k, v, out, lse, b, h, hkv, sq, skv, d, scale, causal, window,
    # q_off, k_off, dtype, stream
    "egt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.c_float, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, dout, lse, delta, dq, b, h, hkv, sq, skv, d, scale,
    # causal, window, q_off, k_off, dtype, stream
    "egt_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, b, h, hkv, sq, skv, d, scale,
    # causal, window, q_off, k_off, dtype, stream
    "egt_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _P],
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
    nvcc = _nvcc()
    # build under temporary names, then rename: a concurrent process
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compiles = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            compiles.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        lib = os.path.join(tmp, path.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                *(obj for _, obj, _ in compiles)]
        logs, failed = [], None
        for cmd, _, proc in compiles:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode)
        if failed is None:
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (link, proc.returncode)
        build_log = "".join(logs)
        if failed is not None:
            cmd, code = failed
            raise RuntimeError(
                f"nvcc failed (exit {code}): {' '.join(cmd)}\n{build_log}"
            )
        os.replace(lib, path)


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
