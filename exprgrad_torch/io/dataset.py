"""Mini-batch dataset iteration: shuffled batches, a prefetching input
pipeline, and a multi-epoch training loop.

The port's copy of ``exprgrad_tpu/io/dataset.py``.  ``Batches`` is the
same (a native Fisher-Yates permutation and row gather per epoch,
:mod:`exprgrad_torch.utils.native`).  :class:`Prefetcher` places batches
with torch: pinned host memory, then a non-blocking copy to the model's
device, where the JAX package calls ``jax.device_put``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.native import gather_rows, shuffle_indices


class Batches:
    """Iterate aligned mini-batches over equally-sized leading dimensions."""

    def __init__(
        self,
        tensors: dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_tail: bool = True,
    ) -> None:
        sizes = {v.shape[0] for v in tensors.values()}
        if len(sizes) != 1:
            raise ValueError("all dataset tensors need the same sample count")
        self.tensors = tensors
        self.count = sizes.pop()
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_tail = drop_tail
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_tail:
            return self.count // self.batch_size
        return -(-self.count // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        self.epoch += 1
        order = None
        if self.shuffle:
            order = shuffle_indices(self.count, self.seed + self.epoch)
        for batch in range(len(self)):
            lo = batch * self.batch_size
            hi = min(lo + self.batch_size, self.count)
            if order is None:
                yield {k: v[lo:hi] for k, v in self.tensors.items()}
            else:
                idx = order[lo:hi]
                yield {k: gather_rows(v, idx) for k, v in self.tensors.items()}


class Prefetcher:
    """Input pipeline that assembles and places the NEXT batch while the
    device computes the CURRENT one.

    A background thread pulls batches from any iterable of
    ``{name: array}`` dicts and casts them to ``dtype``.  With
    ``to_device`` it copies each array to ``placement`` (a
    ``torch.device`` or device string; default ``"cuda"``); to a CUDA
    device through pinned host memory with ``non_blocking=True`` on a
    side stream, so the copy of batch *k+1* overlaps the device's work on
    batch *k*.  The placed tensors go to ``Model.apply`` as they are: a
    tensor already on the model's device and of its dtype is not copied
    again.  Without ``to_device`` it yields the cast numpy arrays.

    A mesh placement (sharded batches) is not ported and raises
    (ROADMAP.md A14: parallelism).

    ``depth`` bounds the queue: at most ``depth`` placed batches are in
    flight.  Exceptions in the producer re-raise at the consuming site;
    abandoning the iterator mid-epoch stops the thread promptly.
    """

    _STOP = object()

    def __init__(
        self,
        batches,
        depth: int = 2,
        dtype: Optional[np.dtype] = None,
        placement=None,
        to_device: bool = True,
    ) -> None:
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        if placement is not None and not isinstance(placement,
                                                    (str, torch.device)):
            raise NotImplementedError(
                "Prefetcher placement must be a torch.device; sharded "
                "placements are not ported to exprgrad_torch yet "
                "(ROADMAP.md A14: parallelism)"
            )
        self.batches = batches
        self.depth = depth
        self.dtype = dtype
        self.device = torch.device(placement if placement is not None
                                   else "cuda")
        self.to_device = to_device

    def __len__(self) -> int:
        return len(self.batches)

    def _place(self, batch: dict[str, np.ndarray], stream=None) -> dict:
        out = {}
        for name, value in batch.items():
            arr = np.ascontiguousarray(value, dtype=self.dtype)
            if self.to_device:
                host = torch.from_numpy(arr)
                if stream is None:
                    arr = host.to(self.device)
                else:
                    with torch.cuda.stream(stream):
                        arr = host.pin_memory().to(self.device,
                                                   non_blocking=True)
            out[name] = arr
        return out

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that aborts when the consumer went away
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        # copies run on a side stream; each batch carries the event of its
        # copy, which the consumer's stream waits for
        stream = (torch.cuda.Stream(self.device)
                  if self.to_device and self.device.type == "cuda" else None)

        def producer() -> None:
            try:
                for batch in self.batches:
                    placed = self._place(batch, stream)
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                        placed = (placed, done)
                    if not put(placed):
                        return
                put(self._STOP)
            except BaseException as exc:  # re-raised at the consumer
                put(exc)

        thread = threading.Thread(
            target=producer, name="egt-prefetch", daemon=True
        )
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, tuple):
                    item, done = item
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(done)
                    for tensor in item.values():
                        # the allocator must not reuse the side stream's
                        # memory while this stream still reads it
                        tensor.record_stream(current)
                yield item
        finally:
            stop.set()
            # free one slot so a producer blocked in put() can observe
            # the stop flag and exit
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10.0)


def fit_epochs(
    model, target: str, batches: Batches, epochs: int = 1, prefetch: int = 0
) -> None:
    """Train ``target`` for several epochs over shuffled batches.

    ``prefetch > 0`` drives the epoch through a :class:`Prefetcher` of
    that depth when the model lives on a CUDA device: the assembly and
    host-to-device copy of the next batch overlap the device step of the
    current one.  On the CPU the batches go to ``Model.apply`` as they
    are.
    """
    dtype = np.dtype(model.program.scalar_type.value)
    use_prefetch = prefetch > 0 and model.device.type == "cuda"
    for _ in range(epochs):
        model.epoch += 1
        it = (
            Prefetcher(batches, depth=prefetch, dtype=dtype,
                       placement=model.device)
            if use_prefetch
            else batches
        )
        for batch in it:
            model.apply(target, batch)
