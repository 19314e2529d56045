"""Load and launch the port's generated Triton kernels (B5, B6).

The emitters of :mod:`exprgrad_torch.ops.mapreduce` and
:mod:`exprgrad_torch.ops.rowchain` write one ``@triton.jit`` source per
scheduled kernel or chain.  Its first call on a device launches through
here (Triton's launcher); the compiled functions then pass to the C++
launcher (:mod:`exprgrad_torch.utils.launcher`).  ``triton.jit`` reads
its function's source through ``inspect``, so the source must live in a
real file: it lands in
``build/exprgrad_torch/triton/<sha256 of the source>.py`` at the
repository root and is imported from there with
``importlib.util.spec_from_file_location``.  Triton compiles the kernel at
its first launch and caches the binary by its source, in
``build/exprgrad_torch/triton/cache`` unless ``TRITON_CACHE_DIR`` names
another place, so the port writes nothing outside its checkout.
``triton`` is imported only here, when a kernel is first loaded: the CPU
tests import every module of the port on machines without it.

Nothing here falls back: a failed import, compile or launch raises, and
the error names the generated file.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import tempfile
import time
from pathlib import Path

from .kernels import BUILD_DIR

TRITON_DIR = BUILD_DIR / "triton"

_loaded: dict[tuple, tuple] = {}  # (sha256, name) -> (function, path)
# seconds spent in first launches (Triton's compile) since import
compile_seconds = 0.0


def source_path(source: str) -> Path:
    """Where a generated source is written."""
    digest = hashlib.sha256(source.encode()).hexdigest()
    return TRITON_DIR / f"{digest}.py"


def load(source: str, name: str):
    """The ``@triton.jit`` function ``name`` of a generated source."""
    path = source_path(source)
    got = _loaded.get((path.stem, name))
    if got is None:
        TRITON_DIR.mkdir(parents=True, exist_ok=True)
        os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_DIR / "cache"))
        if not path.exists():
            # write under a temporary name, then rename: a concurrent
            # process never imports a half-written file
            fd, tmp = tempfile.mkstemp(dir=TRITON_DIR, suffix=".py")
            with os.fdopen(fd, "w") as f:
                f.write(source)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(
            f"egt_triton_{path.stem[:16]}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        for fn_name, value in vars(module).items():  # every kernel of it
            if fn_name.startswith("egt_"):
                _loaded.setdefault((path.stem, fn_name),
                                   (value, path, [False]))
        got = _loaded[(path.stem, name)]
    return got


def handle(kern, name: str, source: str | None = None):
    """:func:`load` of the function ``name`` of ``source`` (by default
    ``kern.source``), kept in ``kern.handles`` so that a launch neither
    hashes nor looks up a source again."""
    got = kern.handles.get(name)
    if got is None:
        got = kern.handles[name] = load(source or kern.source, name)
    return got


def launch(kernel, grid: tuple, num_warps: int, *args):
    """Launch a loaded kernel on the current stream through Triton's
    launcher; the first launch of each kernel compiles it (timed into
    :data:`compile_seconds`).  Returns Triton's compiled kernel (its
    function, metadata and code: :mod:`exprgrad_torch.utils.launcher`
    takes it over)."""
    global compile_seconds
    fn, path, compiled = kernel
    t0 = time.perf_counter() if not compiled[0] else None
    try:
        got = fn[grid](*args, num_warps=num_warps)
    except Exception as err:
        raise RuntimeError(
            f"the generated Triton kernel {path} failed to compile or "
            f"launch: {err}") from err
    if t0 is not None:
        compiled[0] = True
        compile_seconds += time.perf_counter() - t0
    return got
