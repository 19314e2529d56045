"""Wall-clock measurement helper (the reference examples' ``measureTime``
template, examples/fashion_mnist/fashion_mnist.nim:31-35).

On the GPU, asynchronous launches make naive timing lie:
``measure_time`` optionally fences (waits for the device) before reading
the clock.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Optional


@contextmanager
def measure_time(name: str = "", fence: Optional[Callable[[], object]] = None):
    """``with measure_time("fit"):`` prints the elapsed wall time.

    ``fence`` is called before stopping the clock; pass e.g.
    ``torch.cuda.synchronize`` to include the device time of work
    launched asynchronously.
    """
    start = time.perf_counter()
    try:
        yield
    finally:
        if fence is not None:
            fence()
        elapsed = time.perf_counter() - start
        label = name or "elapsed"
        print(f"{label}: {elapsed:.3f}s", flush=True)
