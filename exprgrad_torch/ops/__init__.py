"""Kernels and extern implementations of the port.

The package exports the JAX package's ``exprgrad_tpu.ops`` API, name for
name, with one mapping: ``pallas_matmul`` (the Pallas matmul with
explicit ``block_m/n/k``) is :func:`scheduled_matmul` here, kernel B1
at an explicit ``block``.  Importing the package builds no kernel and
imports no Triton: each kernel is built at its first launch."""

from .attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
)
from .decode import KVCache, append, decode_attention, init_cache
from .matmul import scheduled_matmul
from .paged_attention import paged_decode_attention

__all__ = [
    "KVCache",
    "append",
    "decode_attention",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "init_cache",
    "paged_decode_attention",
    "scheduled_matmul",
]
