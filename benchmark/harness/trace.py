"""The device trace of a traced sub-window, reduced to what the per-layer
metrics read.

``record(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside a ``bench.window`` range that ends in a synchronize,
exports the chrome trace into a temporary directory under ``TMPDIR``,
parses it and deletes it.  ``Trace`` then holds:

* ``ops``: every device operation (kernel, copy, memset) inside the
  window, each with its start, duration, name and the innermost ``bench.``
  range the host was in when it launched the operation (matched through
  the launch's correlation id);
* ``busy_us`` / ``window_us``: the union of the device operations (a
  frozen copy of the port's ``tools/trace_volume.union_us``) and the
  window's length;
* ``gaps``: the device's idle intervals, each named by the ``bench.``
  range the host was in when the gap began (``unspanned`` outside them:
  the harness between volumes, or run_eval's own host work).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import shutil
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::",
                                                "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            return name[:i]
    return name


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    index: int


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float
    dur: float
    span: Span | None


@dataclasses.dataclass
class Trace:
    ops: list[Op]
    window_us: float
    busy_us: float
    gaps: list[tuple[float, str]]


def _innermost(spans: list[Span], starts: list[float], ts: float):
    i = bisect.bisect_right(starts, ts) - 1
    while i >= 0:
        s = spans[i]
        if s.end >= ts:
            # a later-starting range that also covers ts is nested deeper
            return s
        i -= 1
    return None


def parse(events: list[dict]) -> Trace:
    xs = [e for e in events if e.get("ph") == "X"]
    cat = lambda e: e.get("cat", "").lower()
    windows = [e for e in xs if e.get("name") == WINDOW
               and cat(e) == "user_annotation"]
    if not windows:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    lo = windows[0]["ts"]
    hi = lo + windows[0]["dur"]
    spans = sorted((Span(e["name"], e["ts"], e["ts"] + e["dur"], 0)
                    for e in xs if cat(e) == "user_annotation"
                    and e["name"].startswith("bench.")
                    and e["name"] != WINDOW), key=lambda s: s.start)
    for i, s in enumerate(spans):
        s.index = i
    starts = [s.start for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if cat(e) in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    ops = []
    for e in xs:
        if cat(e) not in DEVICE_CATS or e["ts"] + e["dur"] < lo \
                or e["ts"] > hi:
            continue
        host = launch_ts.get(e.get("args", {}).get("correlation"))
        span = None if host is None else _innermost(spans, starts, host)
        ops.append(Op(e["name"], cat(e), e["ts"], e["dur"], span))
    ops.sort(key=lambda o: o.start)
    busy = union_us(((o.start, o.start + o.dur) for o in ops), lo, hi)
    gaps, reach = [], lo
    for o in ops + [Op("", "", hi, 0.0, None)]:
        if o.start > reach:
            span = _innermost(spans, starts, reach)
            gaps.append((o.start - reach, span.name if span else "unspanned"))
        reach = max(reach, min(o.start + o.dur, hi))
    return Trace(ops, hi - lo, busy, gaps)


def record(fn) -> Trace:
    """Run ``fn()`` under the profiler and return its parsed trace; raises
    if the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = parse(json.load(f)["traceEvents"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if tr.busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time: the "
                           "trace did not reach the card")
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, in seconds."""
    per_op = collections.Counter()
    for o in tr.ops:
        per_op[short_name(o.name)] += o.dur
    per_gap = collections.Counter()
    for dur, name in tr.gaps:
        per_gap[name] += dur
    return {"device_ops": [[n, d / 1e6] for n, d in per_op.most_common(top)],
            "idle_gaps": [[n, d / 1e6] for n, d in per_gap.most_common(top)]}
