"""Utilities: the native data-plumbing library, timing helpers, and the
build support of the port's CUDA and Triton kernels (``kernels``,
``triton_build``, imported on their own)."""

from .native import have_native, native_lib
from .timer import measure_time

__all__ = ["have_native", "measure_time", "native_lib"]
