"""Pieces every driver shares: the import guard, the device line, the
profiler slice and its reduction, and small statistics.

Nothing here imports the program; ``torch.profiler`` is imported only
in a traced run (``TraceSlice``).
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "exprgrad_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules the benchmark must not load,
    compared whole (``exprgrad_torch`` is not ``exprgrad_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def mark(ctx, name: str) -> None:
    """Note that set-up phase ``name`` ended now (``ctx.marks``, where the
    run keeps them)."""
    marks = getattr(ctx, "marks", None)
    if marks is not None:
        marks.append((name, time.perf_counter()))


def reference_for(cfg: dict):
    """The plain reference module the configuration names
    (``portbench/reference/<cfg["reference"]>.py``)."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation (numpy's rule)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def device_line(torch, chips: int, trace=None) -> dict:
    dev = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else "cpu"),
           "count": chips,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if torch.cuda.is_available() else 0)}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
    return dev


@dataclass
class Trace:
    """A profiled slice of the window, reduced.  ``kernels`` are the
    device operations in it as ``(name, start_s, seconds)``; ``busy_s``
    the union of their intervals; ``window_s`` the slice's length;
    ``device_ops`` and ``idle_gaps`` the breakdown's two lists."""

    kernels: list = field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def time_of(self, *parts: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name
        contains any of ``parts``."""
        hits = [d for n, _, d in self.kernels if any(p in n for p in parts)]
        return float(sum(hits)), len(hits)


SLICE = "portbench.slice"


def reduce_events(device, host, top: int = 10) -> Trace:
    """Reduce a slice's events: ``device`` and ``host`` are lists of
    ``(name, start_us, end_us)``; the host list holds the slice's own
    span named ``SLICE``, which bounds the window."""
    span = [(s, e) for n, s, e in host if n == SLICE]
    if not span:
        return Trace()
    lo, hi = span[0]
    dev = sorted({(n, max(s, lo), min(e, hi)) for n, s, e in device
                  if e > lo and s < hi}, key=lambda x: x[1])
    kernels = [(n, (s - lo) * 1e-6, (e - s) * 1e-6) for n, s, e in dev]
    # busy: the union of device intervals; idle gaps: its complement
    busy, gaps, cur = 0.0, [], lo
    for _, s, e in dev:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    by_op: dict = {}
    for n, _, d in kernels:
        by_op[n] = by_op.get(n, 0.0) + d
    ops = sorted(by_op.items(), key=lambda x: -x[1])[:top]
    return Trace(kernels=kernels, busy_s=busy * 1e-6,
                 window_s=(hi - lo) * 1e-6,
                 device_ops=[[n[:160], d] for n, d in ops],
                 idle_gaps=label_gaps(gaps, host, top))


def label_gaps(gaps, host, top: int, longest: int = 400) -> list:
    """Idle seconds by what the host was doing: each of the ``longest``
    gaps goes to the innermost host span around its middle (the
    shortest that contains it); the seconds are summed by that span's
    name, largest first."""
    spans = [(n, s, e) for n, s, e in host if n != SLICE]
    if not gaps:
        return []
    starts = np.array([s for _, s, _ in spans] or [0.0])
    ends = np.array([e for _, _, e in spans] or [0.0])
    names = [n for n, _, _ in spans] or ["(none)"]
    out: dict = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = 0.5 * (s + e)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if spans and inside.size:
            name = names[inside[np.argmin(ends[inside] - starts[inside])]]
        else:
            name = "(no host span)"
        out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return [[n[:160], d] for n, d in
            sorted(out.items(), key=lambda x: -x[1])[:top]]


class TraceSlice:
    """``torch.profiler`` over a bounded slice of the window.  Made during
    set-up, which also runs one short session so that the profiler's own
    start-up is not paid inside the window.  ``start`` and ``stop`` are
    called between the window's calls; the slice is wrapped in a
    ``record_function`` span that bounds it; ``finish``, after the
    window, reduces the events."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self._span = None
        self._done = None
        self.trace = None
        self.started = False
        with self._profile():
            self.torch.zeros(1, device=self._device()).add_(1)
        self._sync()

    def _device(self):
        return "cuda" if self.torch.cuda.is_available() else "cpu"

    def _sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def start(self) -> None:
        from torch.profiler import record_function
        self._sync()
        self.started = True
        self.prof = self._profile()
        self.prof.__enter__()
        self._span = record_function(SLICE)
        self._span.__enter__()

    def stop(self) -> None:
        self._sync()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self._done, self.prof = self.prof, None

    def finish(self):
        """The slice reduced (a ``Trace``), or None if none was taken."""
        if self.active:
            self.stop()
        if self._done is None:
            return None
        device, host = [], []
        cuda = self.torch.autograd.DeviceType.CUDA
        for ev in self._done.events():
            row = (ev.name, ev.time_range.start, ev.time_range.end)
            if ev.device_type != cuda:
                host.append(row)
            elif not ev.name.startswith("portbench."):
                # the device's copy of a host span is no operation
                device.append(row)
        self.trace = reduce_events(device, host)
        self._done = None
        return self.trace

    @property
    def active(self) -> bool:
        return self.prof is not None


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span in a traced run's slice (``record_function``)."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    with record_function(name):
        yield
