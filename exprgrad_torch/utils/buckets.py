"""The "pad to the next bucket" policy of ``Model.set_batch_buckets``.

A copy of the JAX package's ``utils/buckets.py`` without its jit cache,
which the port has no use for.
"""

from __future__ import annotations

from ..errors import ModelRuntimeError


def normalize_buckets(buckets, what: str = "bucket"):
    """Validate and normalize: a sorted list of positive ints, or the
    string "pow2" (round up to the next power of two)."""
    if buckets == "pow2":
        return "pow2"
    try:
        bl = sorted(int(b) for b in buckets)
    except (TypeError, ValueError):
        raise ModelRuntimeError(
            f"{what}s must be a non-empty list of positive sizes or "
            "'pow2'"
        ) from None
    if not bl or bl[0] < 1:
        raise ModelRuntimeError(
            f"{what}s must be a non-empty list of positive sizes or "
            "'pow2'"
        )
    return bl


def bucket_for(buckets, n: int) -> int:
    """Smallest bucket >= n; n itself beyond the largest bucket."""
    if buckets == "pow2":
        size = 1
        while size < n:
            size *= 2
        return size
    for size in buckets:
        if size >= n:
            return size
    return n

