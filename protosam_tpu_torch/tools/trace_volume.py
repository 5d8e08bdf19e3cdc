"""A device trace of one steady ``forward_volume`` on the card: the
counterpart of ``tools/trace_volume.py``.

Builds a configuration (as ``pipeline_profile``: ``flagship``,
``flagship_int8``, ``vit_h`` or ``vit_h_unfused``), warms it up with one
``forward_volume``, then runs one more under ``torch.profiler`` (CPU and
CUDA activities) inside a ``forward_volume`` range that ends in a
synchronize, and prints:

- the device busy and idle share: the union of the CUDA kernel, copy and
  memset intervals over that range;
- the top kernels by device time, with call counts;
- where the chrome trace was written (``runs/``, not committed).

If ``key_averages()`` shows no CUDA time (the profiler did not reach the
card), it fails rather than print zeros.  The JAX tool's int8 switch is
``--config flagship_int8``.

    python3 -m protosam_tpu_torch.tools.trace_volume
        [--config flagship|flagship_int8|vit_h|vit_h_unfused]
        [--slice-batch 4]
        [--slices 8] [--top 20] [--logdir runs/trace_volume]
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib

import torch

from protosam_tpu_torch.tools.pipeline_profile import (CONFIGS, build_config,
                                                       volume_inputs)
from protosam_tpu_torch.tools.timing import log, require_cuda
from protosam_tpu_torch.utils.profiling import annotate, trace

RANGE = "forward_volume"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def summarize(events: list[dict], top: int = 20,
              range_name: str = RANGE) -> dict:
    """Busy/idle share over the ``range_name`` annotation and the top
    kernels by summed device time, from chrome-trace events (``ts``/``dur``
    in µs)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == range_name
             and e.get("cat", "").lower() == "user_annotation"]
    if not spans:
        raise ValueError(f"no {range_name!r} range in the trace")
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat", "").lower() in DEVICE_CATS]
    busy = union_us(((e["ts"], e["ts"] + e["dur"]) for e in device), lo, hi)
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        if e["cat"].lower() == "kernel":
            per_name[e["name"]][0] += e["dur"]
            per_name[e["name"]][1] += 1
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    window = hi - lo
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "kernels": len(device),
            "top": [{"name": n, "ms": d / 1e3, "calls": c}
                    for n, (d, c) in ranked]}


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces of anonymous
    units and argument list: ``attention_kernel<__nv_bfloat16, 64, true,
    false>``."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::",
                                                "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def _device_total_us(prof) -> float:
    total = 0.0
    for evt in prof.key_averages():
        total += getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
    return total


def run(config: str = "flagship", slice_batch: int = 4, n_slices: int = 8,
        top: int = 20, logdir: str = "runs/trace_volume") -> dict:
    dev = require_cuda()
    pipe = build_config(config, dev)
    vol, inp = volume_inputs(n_slices, dev)
    pipe.forward_volume(vol, inp, slice_batch=slice_batch)  # warm-up
    torch.cuda.synchronize()
    logdir = pathlib.Path(logdir) / config
    with trace(logdir) as prof:
        with annotate(RANGE):
            pipe.forward_volume(vol, inp, slice_batch=slice_batch)
            torch.cuda.synchronize()
    if _device_total_us(prof) <= 0:
        raise RuntimeError("torch.profiler recorded no CUDA time: the "
                           "trace did not reach the card")
    path = logdir / "trace.json"
    out = summarize(json.loads(path.read_text())["traceEvents"], top)
    out["trace"] = str(path)
    log(f"trace_volume {config}, {n_slices} slices at slice_batch "
        f"{slice_batch}: window {out['window_ms']:.1f} ms "
        f"({out['window_ms'] / n_slices:.2f} ms/slice under the profiler), "
        f"device busy {out['busy_ms']:.1f} ms, idle share "
        f"{100 * out['idle_share']:.1f}% over {out['kernels']} device "
        f"events; trace {path}")
    for k in out["top"]:
        log(f"  {k['ms']:9.2f} ms  x{k['calls']:<5d} "
            f"{100 * k['ms'] / out['busy_ms']:5.1f}%  {short_name(k['name'])}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship", choices=CONFIGS)
    ap.add_argument("--slice-batch", type=int, default=4)
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--logdir", default="runs/trace_volume")
    args = ap.parse_args(argv)
    return run(args.config, args.slice_batch, args.slices, args.top,
               args.logdir)


if __name__ == "__main__":
    main()
