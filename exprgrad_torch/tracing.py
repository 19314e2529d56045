"""Spans at the port's layer boundaries, on while ``torch.profiler`` records.

A span names a piece of the program's work (``egt.batcher.prefill``,
``egt.executor.kernel``, ...).  Spans are on exactly while a
``torch.profiler`` session records (``Model.profile``, an operator's own
profiler): off, :func:`span` returns one shared null context and records
nothing, at the cost of one flag read.  On, a span goes to two sinks:

* the profiler's trace, as a function-scope event
  (``torch._C._profiler._RecordFunctionFast``) on the trace's own clock.
  It is not a user annotation, so the profiler gives it no device copy:
  device time in the trace stays the device's operations.  A torch
  without that class gets no event (the memory record below still is);
* a bounded ring in memory (the newest 2**20 records): the name, start
  and end (``time.perf_counter_ns``), the enclosing span of the same
  thread, the request id and the attributes.  ``span(..., device=True)``
  also brackets the span with CUDA events on the current stream; its
  device seconds are resolved when :func:`spans` reads the ring.

>>> with torch.profiler.profile():
...     model.apply("train", args)
>>> [s for s in tracing.spans() if s["name"] == "egt.executor.kernel"]
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _profiler

RING = 1 << 20

_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
NULL = contextlib.nullcontext()  # what span() gives while off
_Fast = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                None)


def enabled() -> bool:
    """Whether spans record now: a ``torch.profiler`` session is on."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    """A timing CUDA event recorded on the current stream, or None where
    the stream is being captured into a CUDA graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    """One open or finished span; ``attrs`` may be added to until it
    ends.  ``end_event`` is the CUDA event that ended it (None without
    device timing), which the next span of a chain may start from."""

    __slots__ = ("name", "id", "parent", "rid", "attrs", "start_ns",
                 "end_ns", "_device", "_start_event", "end_event", "_fast")

    def __init__(self, name: str, rid, attrs: dict, device):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.id = next(_ids)
        self._device = device
        self._start_event = self.end_event = self._fast = None
        self.parent = self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if _Fast is not None:
            self._fast = _Fast(self.name)
            self._fast.__enter__()
        if self._device is True:
            self._start_event = _event()
        elif self._device:
            self._start_event = self._device
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._start_event is not None:
            self.end_event = _event()
        self.end_ns = time.perf_counter_ns()
        if self._fast is not None:
            self._fast.__exit__(None, None, None)
            self._fast = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _ring.append(self)

    def device_s(self):
        """Seconds between the span's two CUDA events (waiting for the
        second), or None without them."""
        start, end = self._start_event, self.end_event
        if start is None or end is None:
            return None
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


def span(name: str, rid=None, device=None, **attrs):
    """A context for one span named ``name``: the shared null context
    while no profiler records, else a :class:`Span` (``with ... as s``
    gives it, so attributes known only at the end can be set).
    ``device``: True brackets the span with CUDA events on the current
    stream (for work on a CUDA device only); a recorded event starts the
    span from it instead (one event at the boundary of two spans)."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return Span(name, rid, attrs, device)


def record(name: str, start_ns: int, end_ns: int, rid=None,
           **attrs) -> None:
    """Record a span from ``start_ns`` to ``end_ns`` (``perf_counter_ns``'s
    clock), in memory only: the profiler's trace cannot be given times in
    the past.  It has no parent."""
    if not _profiler._is_profiler_enabled:
        return
    s = Span(name, rid, attrs, None)
    s.start_ns, s.end_ns = int(start_ns), int(end_ns)
    _ring.append(s)


def spans() -> list[dict]:
    """The recorded spans in the order they ended, as dicts: ``name``,
    ``id``, ``parent`` (the enclosing span's id, or None), ``rid``,
    ``attrs``, ``start_ns``, ``end_ns`` and ``device_s`` (None where the
    span had no CUDA events)."""
    return [{"name": s.name, "id": s.id, "parent": s.parent, "rid": s.rid,
             "attrs": dict(s.attrs), "start_ns": s.start_ns,
             "end_ns": s.end_ns, "device_s": s.device_s()}
            for s in list(_ring)]


def clear() -> None:
    """Empty the ring."""
    _ring.clear()
