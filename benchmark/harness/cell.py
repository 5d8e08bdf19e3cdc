"""One run of one cell: build the program from the seed, warm the cell's
shapes, measure the window, optionally trace a tail of the same traffic,
free the program, check its outputs against the reference and reduce the
readings to the manifest's metrics.

Everything a cell needs is found by name: the workload in
``BENCHMARK.json``, its configuration file, ``traffic/<traffic>.json``
(whose ``driver`` picks ``drivers/<driver>.py``), ``limits/<workload>.json``,
``families/<family>.py`` for each encoder of the configuration
(``harness/family.py``) and ``metrics/<metric>.py`` for every metric the
cell reports.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

import torch

from benchmark.harness import checks, probe, traffic, weights
from benchmark.harness import trace as tracing
from benchmark.harness.family import ROOT
# top-level module names whose presence after the window fails the run:
# the JAX package and JAX itself (compared whole: the port's name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "protosam_tpu")


@dataclasses.dataclass
class Measured:
    """What the metric readers read."""

    cfg: dict
    mix: dict
    setup_s: float
    window_s: float
    calls: int
    slices: int
    summary: dict
    layer_ms: dict
    trace: tracing.Trace | None
    host_spans: list
    call_spans: list
    root: pathlib.Path = ROOT


def manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, name: str, root: pathlib.Path = ROOT):
    """(workload, configuration, mix, limits) of workload ``name``."""
    work = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic"
                      / f"{work['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits"
                         / f"{name}.json").read_text())
    return work, cfg, mix, limits


def metric_names(bench: dict, work: dict, traced: bool) -> list[dict]:
    """The cell's metrics: end-to-end untraced, per-layer traced; a metric
    without ``workloads`` goes to every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or work["name"] in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}

    def here(m):
        if "workloads" in m:
            return work["name"] in m["workloads"]
        return m["moves"] in names

    return [m for m in bench["per_layer"] if here(m)]


def read_metric(name: str, m: Measured, root: pathlib.Path = ROOT):
    """``benchmark/metrics/<name>.py``'s reading, or None where it found
    nothing to read."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    return traffic.load(path, "bench_metric").read(m)


def program_config(cfg: dict, variant: str | None):
    """The program's ``Config`` of a configuration file; ``variant
    "int8"`` turns on the program's own int8 path (the control of the
    encoders' numbers).  ``variant "lowref"`` runs the program as
    configured and also reads the float32 stages' control
    (``checks.volume_readings(lower=True)``)."""
    from protosam_tpu_torch.utils.config import Config

    c, p = cfg["coarse"], cfg["pipeline"]
    return Config(modelname=cfg["program"]["modelname"],
                  protosam_sam_ver=cfg["program"]["protosam_sam_ver"],
                  input_size=(c["input_size"], c["input_size"]),
                  proto_grid_size=c["proto_grid"], do_cca=p["do_cca"],
                  point_mode=p["point_mode"], use_points=p["use_points"],
                  use_bbox=p["use_bbox"], max_ccs=p["max_ccs"],
                  dtype=p["dtype"], slice_batch=p["slice_batch"],
                  use_fused_alp=p["use_fused_alp"],
                  quant_dense=p["quant_dense"] or variant == "int8",
                  log_dir="")


def build(cfg: dict, seed: int, device, variant: str | None = None,
          root: pathlib.Path = ROOT):
    from protosam_tpu_torch.eval.protosam_eval import build_models

    wc, ws = weights.state_dicts(cfg, seed, device, root)
    pipe = build_models(program_config(cfg, variant), device=device,
                        coarse_state=wc, sam_state=ws,
                        fused_mlp=cfg["pipeline"]["fused_mlp"],
                        fused_proj=cfg["pipeline"]["fused_proj"])
    del wc, ws
    return pipe


def card() -> dict:
    """The card's name, power limit and clocks (``nvidia-smi``)."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return {"nvidia_smi": out.splitlines()[0] if out else "",
            "query": q}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, traced: bool, t0: float,
        device=None, variant: str | None = None, root=ROOT,
        hooks=None) -> tuple[dict, list[str], list[dict]]:
    """One run of workload ``name``.  Returns (the result line's object,
    the compared numbers' lines, earlier lines to print).  ``device``
    None means the card, checked by the caller; ``hooks`` (tests) may
    break the program after it is built: ``hooks(pipe)``."""
    bench = manifest(root)
    work, cfg, mix, limits = cell_files(bench, name, root)
    device = torch.device(device or "cuda:0")
    on_card = device.type == "cuda"
    held = {"pipe": build(cfg, seed, device, variant, root)}
    if hooks:
        hooks(held["pipe"])
    drv = traffic.driver(mix, root)(cfg, mix, seed, device)
    try:
        return _measure(bench, work, cfg, mix, limits, held, drv, seed,
                        seconds, traced, t0, device, on_card, variant, root)
    finally:
        drv.close()


def _measure(bench, work, cfg, mix, limits, held, drv, seed, seconds,
             traced, t0, device, on_card, variant, root):
    pipe = held.pop("pipe")
    drv.warm(pipe)
    pr = probe.Probe(pipe, timing=traced and on_card,
                     annotate=traced and on_card,
                     eval_span=mix["driver"] == "eval")
    setup_s = time.perf_counter() - t0
    out = drv.window(pipe, pr, seconds, check=True)
    layer_ms = pr.layer_ms() if traced and on_card else {}
    host_spans = list(pr.host_spans)
    tr = None
    if traced and on_card:
        pr.host_spans.clear()
        tr = tracing.record(lambda: drv.extra(pipe, drv.trace_calls))
    mem = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = drv.summary()
    m = Measured(cfg, mix, setup_s, out["wall_s"], summary["calls"],
                 summary["slices"], summary, layer_ms, tr, host_spans,
                 out.get("call_spans", []), root)
    # free the program before the reference runs
    del pr, pipe
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    ref = checks.Reference(cfg, seed, device, root)
    readings = drv.readings(ref, out)
    lowref = drv.readings(ref, out, lower=True) if variant == "lowref" \
        else None
    del ref, out
    check_s = time.perf_counter() - c0
    correct, lines = checks.judge(readings, limits)
    metrics = {}
    for spec in metric_names(bench, work, traced):
        v = read_metric(spec["name"], m, root)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct), "attempted": m.calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in readings.items()}
    if lowref is not None:
        result["lowref"] = lowref
    earlier = [{"card": card() if on_card else None,
                "memory_peak_bytes": int(mem), "setup_s": setup_s,
                "window_s": m.window_s, "check_s": check_s, "seed": seed,
                "variant": variant},
               {"traffic": summary}]
    return result, lines, earlier
