"""Double-buffered host-to-device prefetch (JAX ``data/prefetch.py``): the
input pipeline must not stall the encoders.

``device_prefetch`` wraps any iterator of host batches (tensors or numpy
arrays in dicts, lists and tuples): while the card computes on batch i,
batch i+1 is already being copied.  On a CUDA device each batch is staged
in pinned host memory and copied with ``non_blocking=True`` on a side
stream; the consumer's stream waits on that copy through an event, and
every tensor records the consumer's stream, so the caching allocator does
not reuse its memory while the consumer's kernels (which launch on the
current stream) may still read it.  ``device="cpu"`` is a path of its own:
tensors, no pinning, no streams.  ``VolumePrefetcher`` also overlaps the
host-side decode and assembly in a worker thread.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _pinned(x) -> torch.Tensor:
    t = _as_tensor(x)
    return t.pin_memory() if t.device.type == "cpu" else t


class _Copier:
    """Copies host batches to ``device``: on a CUDA device through pinned
    memory on a side stream, each copy marked with an event that the
    consumer waits on when it takes the batch."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def put(self, batch):
        if not self.cuda:
            return _tree_map(lambda x: _as_tensor(x).to(self.device), batch),\
                None
        with torch.cuda.stream(self.stream):
            out = _tree_map(lambda x: _pinned(x).to(
                self.device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, staged):
        """The batch, once the consumer's current stream waits on its
        copy."""
        out, done = staged
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            _tree_map(lambda t: t.record_stream(consumer), out)
        return out


def device_prefetch(iterator: Iterable, size: int = 2,
                    device: torch.device | str = "cuda") -> Iterator[Any]:
    """Yield batches on ``device`` (the card unless the caller asks for
    the CPU), keeping ``size`` copies in flight."""
    copier = _Copier(device)
    buf = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(copier.put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(copier.put(next(it)))
        except StopIteration:
            pass
        yield copier.take(out)


class VolumePrefetcher:
    """A producer thread assembling host batches and starting their copies
    to ``device`` (the card unless the caller asks for the CPU).

    produce_fn(i) -> a batch (tensors or numpy arrays in dicts, lists and
    tuples) for step i, or None to stop."""

    def __init__(self, produce_fn: Callable[[int], Any], n_steps: int,
                 depth: int = 2, device: torch.device | str = "cuda"):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.copier = _Copier(device)
        self._thread = threading.Thread(
            target=self._work, args=(produce_fn, n_steps), daemon=True)
        self._thread.start()

    def _work(self, produce_fn, n_steps):
        for i in range(n_steps):
            batch = produce_fn(i)
            if batch is None:
                break
            self.q.put(self.copier.put(batch))
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield self.copier.take(item)
