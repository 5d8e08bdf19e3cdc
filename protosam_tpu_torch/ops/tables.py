"""Shape-only tables, built once per key and device and then reused.

Index and weight tables that depend on sizes alone (a resize's source rows,
the rel-pos index, SAM's pixel mean) were built on the host and copied to
the card on every call.  A copy from pageable host memory makes PyTorch
synchronise the stream, so each one drained the card's queue and the host
could no longer run ahead of it.  ``device_table`` builds a table once per
``(key, device)``, with the caller's host arithmetic, and hands out that
one tensor after.  Callers index with it or use it in arithmetic and never
write to it in place.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable

import torch

# the tables kept: every shape of a pipeline fits, and tools and evals
# that see many shapes cannot grow it without limit
CAPACITY = 256

_tables: collections.OrderedDict = collections.OrderedDict()
_lock = threading.Lock()  # the data layer resizes labels on a thread pool


def device_table(key: Hashable, build: Callable, device) -> torch.Tensor:
    """The tensor ``build()`` gives (a numpy array or a tensor), placed on
    ``device``: built on the first call for ``(key, device)``, the same
    tensor on every later one while it stays among the ``CAPACITY`` most
    recently used.  ``key`` names the table and everything it is built
    from; ``device_table.builds`` counts the builds, as a kernel wrapper's
    ``launches`` counts its launches."""
    k = (key, torch.device(device))
    with _lock:
        t = _tables.get(k)
        if t is not None:
            _tables.move_to_end(k)
            return t
    # a plain tensor even when first built under inference_mode, so that
    # autograd may save it later (an index of a gather under grad)
    with torch.inference_mode(False):
        t = torch.as_tensor(build(), device=device)
    with _lock:
        device_table.builds += 1
        t = _tables.setdefault(k, t)
        _tables.move_to_end(k)
        while len(_tables) > CAPACITY:
            _tables.popitem(last=False)
    return t


device_table.builds = 0
