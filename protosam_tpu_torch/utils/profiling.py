"""The program's tracer (a flight recorder of spans), and device traces
on the card.

* ``span(name, device=None, **attrs)`` — a context manager that records
  one span: its name (``<layer>.<what>``, as ``eval.load_fold``), start
  and end (``time.perf_counter_ns()``), the id of its parent span (0 for
  none), a request id (the id of the outermost span open on the thread
  when it began, so every span under one ``run_eval`` or one bare
  ``forward_volume`` shares it) and its attributes (``attrs``, a dict the
  code may add counts to while the span is open).  ``count(key, n)`` adds
  ``n`` to ``key`` on every span open on the thread, so a count made where
  the work happens (bytes a file decodes) also lands on the spans around
  it.
* Work handed to another thread names its parent: ``span(name,
  parent=s)`` takes ``s``'s id as its parent and ``s``'s request, whatever
  the thread (``current()`` is the innermost span open on this one).
  Counts stay on the thread that made them: ``tally()`` gathers a
  thread's counts in a dict, which the code that handed the work out adds
  to its own spans once the work is back.
* Finished spans go into a ring of ``CAPACITY`` records, process-wide as
  a logger is: ``spans()`` returns them by start, ``dropped()`` counts
  those the ring overwrote, ``clear()`` empties it, and ``summary(spans)``
  gives per name the count, total ms, self ms (less the time its child
  spans cover, overlapping children counted once), where recorded device
  ms, and the sums of the spans' numeric attributes (``counts``).
  Attributes are counts; identifiers are given as strings.
  ``spans(within=s)`` is ``s`` and the spans under it.  Nothing is written
  to a file.
* Host spans are always recorded, at a couple of µs a span: the record
  and its attributes are the only allocations, and there is no lock.
  With ``PROTOSAM_TRACE=1`` in the environment or after ``enable()``, a
  span given a CUDA ``device`` also records a CUDA event pair on that
  device's current stream; the elapsed times are read only in
  ``summary()``.  Then, and whenever a ``torch.profiler`` session is
  active, every span also opens a ``torch.profiler.record_function``
  range named ``protosam.<layer>/<what>``, which puts the program's spans
  on the device trace's clock (a session records the ranges of the
  threads it profiles: ``profile_all_threads`` for the fold's load).
* ``trace`` — ``torch.profiler`` with CPU and CUDA activities around a
  block, exported as a chrome trace.
* ``annotate`` — a named range (``torch.profiler.record_function``) that
  shows up in the trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib
import threading
import time

import torch
import torch.autograd.profiler

CAPACITY = 65536


def _profiler_enabled() -> bool:
    """Whether a ``torch.profiler`` session is active, on any thread (the
    session records the ranges of the threads it profiles)."""
    return torch.autograd.profiler._is_profiler_enabled


class Span:
    """One span; also the ring's record of it once it has ended."""

    __slots__ = ("name", "id", "parent", "request", "start", "end", "attrs",
                 "seq", "_rec", "_device", "_events", "_range",
                 "_given_parent")

    def __init__(self, rec: "Recorder", name: str, device, attrs: dict,
                 parent: "Span | None" = None):
        self._rec = rec
        self.name = name
        self._device = device
        self.attrs = attrs
        self._events = None
        self._range = None
        self._given_parent = parent

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._stack()
        self.id = next(rec._ids)
        top = self._given_parent or (stack[-1] if stack else None)
        if top is not None:
            self.parent, self.request = top.id, top.request
        else:
            self.parent, self.request = 0, self.id
        stack.append(self)
        if rec.enabled or _profiler_enabled():
            layer, _, what = self.name.partition(".")
            self._range = torch.profiler.record_function(
                f"protosam.{layer}/{what}")
            self._range.__enter__()
            dev = self._device
            if rec.enabled and dev is not None and dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(stream)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        rec = self._rec
        rec._local.stack.pop()
        self.seq = next(rec._seq)
        rec._ring[self.seq % rec.capacity] = self
        return False

    def duration_ns(self) -> int:
        return self.end - self.start

    def device_ms(self) -> float | None:
        """The CUDA events' elapsed ms (waits for the end event), or None
        where the span recorded none."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])


class Recorder:
    """A ring of finished spans and, per thread, the stack of open ones."""

    def __init__(self, capacity: int = CAPACITY, enabled: bool = False):
        self.capacity = capacity
        self.enabled = enabled
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.clear()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, device=None, parent: Span | None = None,
             **attrs) -> Span:
        return Span(self, name, device, attrs, parent)

    def current(self) -> Span | None:
        """The innermost span open on this thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to ``key`` on every span open on this thread, and in
        each of its open ``tally`` dicts."""
        for s in self._stack():
            s.attrs[key] = s.attrs.get(key, 0) + n
        for t in getattr(self._local, "tallies", ()):
            t[key] = t.get(key, 0) + n

    @contextlib.contextmanager
    def tally(self):
        """A dict of the counts made on this thread inside the block, for
        work run on a thread other than the one whose spans it counts
        for."""
        try:
            tallies = self._local.tallies
        except AttributeError:
            tallies = self._local.tallies = []
        t: dict = {}
        tallies.append(t)
        try:
            yield t
        finally:
            tallies.pop()

    def spans(self, within: Span | None = None) -> list[Span]:
        """The ring's spans by start; with ``within``, that span and the
        spans under it (its request's, inside its interval)."""
        out = [s for s in self._ring if s is not None]
        if within is not None:
            out = [s for s in out if s.request == within.request
                   and within.start <= s.start and s.end <= within.end]
        out.sort(key=lambda s: (s.start, s.id))
        return out

    def dropped(self) -> int:
        """Spans the ring overwrote since it was last cleared."""
        last = max((s.seq for s in self._ring if s is not None), default=-1)
        return max(0, last + 1 - self.capacity)

    def clear(self) -> None:
        self._ring: list[Span | None] = [None] * self.capacity
        self._seq = itertools.count()


def _add_counts(into: dict, attrs: dict, prefix: str = "") -> None:
    """Add ``attrs``' numbers to ``into``; a dict of numbers (the launch
    counts) goes in under ``<key>.<its key>``."""
    for k, v in attrs.items():
        if isinstance(v, dict):
            _add_counts(into, v, f"{prefix}{k}.")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            into[prefix + k] = into.get(prefix + k, 0) + v


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    """The time the (start, end) intervals cover, overlaps counted once."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total, reach = total + b - a, b
        elif b > reach:
            total, reach = total + b - reach, b
    return total


def summary(spans: list[Span]) -> dict[str, dict]:
    """Per span name: ``count``, ``total_ms``, ``self_ms`` (each span's
    duration less the time its children among ``spans`` cover, children
    that ran at once on other threads counted once), where the spans
    recorded CUDA events ``device_ms``, and where they carry numeric
    attributes ``counts`` (their sums, as ``{"slices": 88,
    "launches.K1": 960}``)."""
    ids = {s.id for s in spans}
    children: dict[int, list] = {}
    for s in spans:
        if s.parent in ids:
            children.setdefault(s.parent, []).append((s.start, s.end))
    child_ns = {i: _union_ns(c) for i, c in children.items()}
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        dur = s.duration_ns()
        row["count"] += 1
        row["total_ms"] += dur / 1e6
        row["self_ms"] += (dur - child_ns.get(s.id, 0)) / 1e6
        dev = s.device_ms()
        if dev is not None:
            row["device_ms"] = row.get("device_ms", 0.0) + dev
        if s.attrs:
            _add_counts(row.setdefault("counts", {}), s.attrs)
    for row in out.values():
        if not row.get("counts", True):
            del row["counts"]
    return out


def report(table: dict[str, dict]) -> str:
    """``summary``'s table as lines, largest total first, each name's
    counts after its times."""
    lines = []
    for name, row in sorted(table.items(), key=lambda kv: -kv[1]["total_ms"]):
        dev = (f", device {row['device_ms']:.2f} ms" if "device_ms" in row
               else "")
        counts = "".join(f" {k}={v:g}" for k, v in
                         sorted(row.get("counts", {}).items()))
        lines.append(f"{name}: {row['total_ms']:.2f} ms x{row['count']} "
                     f"(self {row['self_ms']:.2f} ms{dev}){counts}")
    return "\n".join(lines)


_recorder = Recorder(enabled=os.environ.get("PROTOSAM_TRACE", "0")
                     not in ("", "0"))
span = _recorder.span
current = _recorder.current
count = _recorder.count
tally = _recorder.tally
spans = _recorder.spans
dropped = _recorder.dropped
clear = _recorder.clear


def enable(on: bool = True) -> None:
    """Device events and profiler ranges on every span (as
    ``PROTOSAM_TRACE=1``), or off again."""
    _recorder.enabled = on


def enabled() -> bool:
    return _recorder.enabled


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
