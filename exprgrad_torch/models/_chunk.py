"""One chunk of decode steps as one CUDA graph replay.

The JAX package runs a continuous batcher's ``decode_chunk`` steps in one
jitted ``lax.scan`` and keeps ``pipeline`` more such dispatches in
flight, reading each chunk's tokens back only when it drains
(``exprgrad_tpu/models/batcher.py``).  What that amortizes is the host:
one round trip and one dispatch a chunk.  The port's decode step is
eager, about 50 operators a block a step, and the card idles through
most of it, so the counterpart here is :class:`ChunkGraph`: the chunk's
steps captured once as a CUDA graph over static device buffers and
replayed once a dispatch.

* A dispatch copies the host's inputs (``last``, ``pos``, the budget
  fence ``stop_at``, the page table and the sampling parameters) into the
  static buffers from pinned staging, replays, and copies the chunk's
  tokens into a pinned host buffer of its own, fenced by an event: the
  graph's static output is overwritten by the next replay.  Nothing is
  read back until :meth:`Pending.tokens`.
* The graph writes each row's final ``(tok, pos)`` back into its own
  input buffers, so a dispatch chained on the previous one (the
  pipeline) leaves them in place: the chain stays on the stream.
* Capture follows one warm-up step on the capture stream (every row
  parked, so it writes nothing live), which builds and loads what the
  step launches: kernel B7's library, cuBLAS's handles.
* The pools or caches the graph captured must be the tensors of every
  replay (the batcher writes them in place); a replay with others
  raises.  A capture or replay that fails raises: nothing falls back to
  the eager steps.
* The kernels' launch counters count in their wrappers, which run at
  capture, not at a replay: the launches captured are taken out of the
  counters and added back once a replay.

On the CPU the batcher runs the same steps eagerly (the plain version);
only a CUDA device captures.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..ops import (attention, mamba, mapreduce, matmul, paged_attention,
                   rowchain)

# (module, counter) of every kernel launch counter a step may advance,
# and of the weight products a step sent to torch
_COUNTED = tuple((m, "launches") for m in (
    attention, matmul, mapreduce, rowchain, paged_attention)) + (
    (mamba, "scan_launches"), (mamba, "conv_launches"),
    (matmul, "skinny_launches"), (matmul, "skinny_declined"))


def _counts() -> list:
    return [getattr(m, name) for m, name in _COUNTED]


def _add(counts) -> None:
    for (m, name), n in zip(_COUNTED, counts):
        setattr(m, name, getattr(m, name) + n)


class Pending:
    """An issued chunk's tokens ``[chunk, slots]``: ready on the CPU, or
    a pinned host copy and the event that fences it."""

    def __init__(self, toks, event=None):
        self._toks, self._event = toks, event

    def tokens(self) -> np.ndarray:
        with tracing.span("egt.batcher.readback"):
            if self._event is not None:
                self._event.synchronize()
            return self._toks.numpy()


def _storage(caches) -> list:
    return [t.data_ptr() for c in caches for t in c
            if isinstance(t, torch.Tensor)]


class ChunkGraph:
    """``steps(tok, pos, stop_at, table, temp, top_k, top_p)`` captured
    once, over static buffers of ``slots`` rows and ``width`` page-table
    entries a row, and replayed by :meth:`launch`.  ``steps`` returns
    ``(toks [chunk, slots], tok, pos)``; its warm-up runs one step,
    ``steps(..., n=1)``, with every row parked, from the first
    dispatch's inputs (``ints``, ``floats`` and ``chained`` as
    :meth:`launch` takes them).  ``generator`` is the one the steps draw
    from (registered with the graph), None when no row samples."""

    def __init__(self, steps, slots: int, width: int, caches, device,
                 ints, floats, chained=None, generator=None):
        self.slots, self.replays = slots, 0
        s = slots
        self._ints = torch.zeros(3 * s + s * width, dtype=torch.int32,
                                 device=device)
        self._floats = torch.zeros(3 * s, dtype=torch.float32,
                                   device=device)
        # ints: pos, stop_at, top_k, table; floats: tok, temp, top_p
        self.pos, stop_at = self._ints[:s], self._ints[s:2 * s]
        top_k, table = self._ints[2 * s:3 * s], self._ints[3 * s:].view(
            s, width)
        self.tok, temp = self._floats[:s], self._floats[s:2 * s]
        top_p = self._floats[2 * s:]
        self._storage = _storage(caches)
        self._inputs(ints, floats, chained)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # parked: stop_at = pos, so paged rows write the trash page
            # and dense rows their own next slot, which the step rewrites
            steps(self.tok, self.pos, self.pos, table, temp, top_k, top_p,
                  n=1)
        stream.synchronize()
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            if not hasattr(self.graph, "register_generator_state"):
                raise RuntimeError(
                    "a sampled chunk dispatch draws from the batcher's "
                    "generator inside a CUDA graph, which needs "
                    "torch.cuda.CUDAGraph.register_generator_state; this "
                    f"torch ({torch.__version__}) has none")
            self.graph.register_generator_state(generator)
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.toks, tok, pos = steps(self.tok, self.pos, stop_at,
                                            table, temp, top_k, top_p)
                self.tok.copy_(tok)
                self.pos.copy_(pos)
        finally:
            self.captured = [n - b for n, b in zip(_counts(), before)]
            _add([-n for n in self.captured])
        torch.cuda.current_stream(device).wait_stream(stream)

    def launch(self, ints: np.ndarray, floats: np.ndarray, caches,
               chained=None) -> Pending:
        """One replay.  ``ints`` and ``floats`` are the host's inputs in
        the buffers' layout; ``chained`` is the previous dispatch's
        device ``(tok, pos)``, whose values this one starts from instead
        of the host's ``last`` and ``pos``."""
        if _storage(caches) != self._storage:
            raise RuntimeError(
                "the batcher's KV caches are not the tensors the chunk "
                "graph captured; a CUDA graph replays on fixed storage")
        self._inputs(ints, floats, chained)
        self.graph.replay()
        self.replays += 1
        _add(self.captured)
        host = torch.empty(self.toks.shape, dtype=self.toks.dtype,
                           pin_memory=True)
        host.copy_(self.toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return Pending(host, event)

    def _inputs(self, ints, floats, chained) -> None:
        """The host's inputs into the static buffers, from pinned staging
        (freed for reuse only once the copy ran); a chained dispatch keeps
        the device's ``tok`` and ``pos``."""
        start = 0 if chained is None else self.slots
        staged = [torch.from_numpy(np.ascontiguousarray(a[start:]))
                  .pin_memory() for a in (ints, floats)]
        self._ints[start:].copy_(staged[0], non_blocking=True)
        self._floats[start:].copy_(staged[1], non_blocking=True)
        if chained is not None:
            tok, pos = chained
            if tok is not self.tok:
                self.tok.copy_(tok)
                self.pos.copy_(pos)
