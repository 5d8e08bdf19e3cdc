"""Stage timing and device traces on the card: the counterpart of
``protosam_tpu/utils/profiling.py``.

* ``StageTimer`` — named wall-clock stages, each ended (and begun) by
  ``torch.cuda.synchronize(device)`` where the JAX version blocks on an
  array, accumulated per name; the same ``report()`` and ``as_dict()``.
* ``trace`` — ``torch.profiler`` with CPU and CUDA activities around a
  block, exported as a chrome trace.
* ``annotate`` — a named range (``torch.profiler.record_function``) that
  shows up in the trace.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates wall time per stage name.  With ``sync`` (the default)
    every stage starts and ends with ``torch.cuda.synchronize(device)``, so
    a stage is charged its own device work and nothing queued before it;
    that needs a card, and without one the constructor raises."""

    def __init__(self, device: torch.device | str = "cuda",
                 sync: bool = True):
        if sync and not torch.cuda.is_available():
            raise RuntimeError("StageTimer(sync=True) times the card: CUDA "
                               "is not available")
        self.device = device
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {t * 1000:.1f} ms total, "
                         f"{t / max(n, 1) * 1000:.2f} ms/call x{n} "
                         f"({100 * t / max(total, 1e-9):.0f}%)")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": v, "calls": self.counts[k]}
                for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(logdir: str | pathlib.Path):
    """``torch.profiler`` (CPU + CUDA activities) around the block; yields
    the profiler and writes ``logdir/trace.json`` (chrome trace format)
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str):
    """Named range visible in the profiler trace."""
    return torch.profiler.record_function(name)
