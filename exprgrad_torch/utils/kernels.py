"""Build and bind the port's CUDA kernels (``exprgrad_torch/csrc/*.cu``).

The counterpart of ``exprgrad_tpu/utils/native.py``, for device code:
the sources are compiled with ``nvcc`` by hand, one process per ``.cu``
file, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/exprgrad_torch/`` at the repository root, named by a hash of the
sources and flags, so a second process (or a second call) reuses it.

The launcher of the generated Triton kernels (``csrc/launch.cpp``, the
ops' CUDA implementations, :mod:`exprgrad_torch.utils.launcher`) is
built the same way by :func:`load_launcher`, with the host compiler
against PyTorch's headers and libraries (it includes no CUDA header),
into ``build/exprgrad_torch/libegt_launch_<hash>.so``.

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
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "exprgrad_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# Limits of the matmul epilogue program (csrc/matmul.cuh kMax*).
EPI_MAX_CODE = 64
EPI_MAX_REGS = 32
EPI_MAX_CONSTS = 32
EPI_MAX_EXTRA = 8


class EpiProgram(ctypes.Structure):
    """``struct EpiProgram`` of csrc/matmul.cuh, passed by value."""

    _fields_ = [
        ("n_code", _I),
        ("n_extra", _I),
        ("code", (_I * 4) * EPI_MAX_CODE),
        ("consts", ctypes.c_float * EPI_MAX_CONSTS),
        ("extra_pattern", _I * EPI_MAX_EXTRA),
        ("extra", _P * EPI_MAX_EXTRA),
    ]


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
    # FlashFwdArgs (egt_flash_fwd's arguments but the stream), stream
    "egt_flash_fwd_packed": [_P, _P],
    # a, b, c, m, n, k, transpose, in_dtype, out_dtype, bm, bn, bk,
    # program, stream
    "egt_matmul": [_P, _P, _P] + [_I] * 9 + [EpiProgram, _P],
    # MatmulArgs (a .. bk), &program, stream
    "egt_matmul_packed": [_P, _P, _P],
    # field index -> MatmulArgs' byte offset (its size past the last)
    "egt_matmul_args_offset": [_I],
    # &SplitArgs, stream (gemm_sm90.cu)
    "egt_tf32_split": [_P, _P],
    # &GemmArgs, stream (gemm_sm90.cu)
    "egt_gemm_tf32x3": [_P, _P],
    # q, k, v, k_scale, v_scale, table, key_pos, q_pos, out, part, b, h,
    # hkv, n_pages, t, d, page, n_tbl, scale, window, vec, n_split, pps,
    # q_dtype, kv_dtype, stream
    "egt_paged_decode": [_P] * 10 + [_I] * 8 + [ctypes.c_float]
                        + [_I] * 6 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)
compile_seconds: dict = {}  # source file -> seconds of its nvcc, last build


def _torch_dirs() -> tuple[Path, Path]:
    """PyTorch's header and library directories."""
    root = Path(torch.__file__).resolve().parent
    return root / "include", root / "lib"


def launcher_flags() -> list[str]:
    include, lib = _torch_dirs()
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return ["-std=c++17", "-O2", "-fPIC", "-shared",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}", f"-I{include}",
            f"-L{lib}", f"-Wl,-rpath,{lib}"]


_LAUNCHER_LIBS = ("-lc10", "-ltorch_cpu", "-ltorch", "-ldl")


def launcher_path() -> Path:
    """Where the launcher for the current source, flags and PyTorch
    lives (it is built against PyTorch's C++ ABI)."""
    digest = hashlib.sha256(" ".join(launcher_flags()).encode())
    digest.update(torch.__version__.encode())
    digest.update((_CSRC / "launch.cpp").read_bytes())
    return BUILD_DIR / f"libegt_launch_{digest.hexdigest()[:16]}.so"


def load_launcher() -> Path:
    """The launcher library's path, built on first use (``$CXX`` or
    ``c++``; about 10 s on the H100's host)."""
    path = launcher_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (c++, g++ or $CXX) to build "
                           "exprgrad_torch/csrc/launch.cpp")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, path.name)
        cmd = [cxx, *launcher_flags(), "-o", out,
               str(_CSRC / "launch.cpp"), *_LAUNCHER_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"the launcher failed to build (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(out, path)
    return path


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
        t0 = time.perf_counter()
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
        # each compile's output and the seconds from the start to its exit
        # (they run together, so the build takes the longest of them)
        done = {}

        def finish(cmd, proc):
            out, _ = proc.communicate()
            done[cmd[-1]] = (out, time.perf_counter() - t0)

        waits = [threading.Thread(target=finish, args=(cmd, proc))
                 for cmd, _, proc in compiles]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        logs, failed = [], None
        for cmd, _, proc in compiles:
            out, secs = done[cmd[-1]]
            logs.append(out)
            compile_seconds[Path(cmd[-1]).name] = round(secs, 1)
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


_entries: dict = {}  # entry point name -> bound ctypes function


def call(name: str, device: torch.device, *args) -> None:
    """Launch C entry point ``name`` on ``device`` and its current stream,
    whose handle is appended to ``args``; raises if the launch failed.
    The device is switched only when it is not the current one: a launch
    is on every call's path, so it stays cheap on the host (the bound
    function is looked up once, the current device read without
    ``torch.cuda``'s Python layer)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(load(), name)
    index = device.index
    current = torch._C._cuda_getDevice()
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, name)
