"""One training step of the ALPNet coarse model on the card, timed alone
and traced: where a step's time goes.

Builds ``train.trainer.build_coarse_model`` (DINOv2-L/14 at 672 by
default, bf16 with f32 master weights, seeded), one fixed synthetic
episode (smooth slices and a square label, no augmentation and no
prefetch threads), and SGD with the trainer's defaults; after two warm-up
steps it times ``--steps`` steps on the host clock, each ending in a
synchronize, then runs one more under ``torch.profiler`` inside a
``train_step`` range and prints the device busy and idle share and the
top kernels (as ``trace_volume``; chrome trace under ``runs/``).  Set
beside ``train()``'s own ms/step, the isolated step shows what the
trainer's host work costs.

    python3 -m protosam_tpu_torch.tools.trace_train_step
        [--model dinov2_l14] [--size 672] [--steps 3] [--top 12]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import time

import numpy as np
import torch

from protosam_tpu_torch.tools.timing import log, require_cuda
from protosam_tpu_torch.tools.trace_volume import (_device_total_us,
                                                   short_name, summarize)
from protosam_tpu_torch.train.step import Batch, make_optimizer, train_step
from protosam_tpu_torch.train.trainer import build_coarse_model
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.profiling import annotate, trace
from protosam_tpu_torch.utils.synthetic import smooth_volume

RANGE = "train_step"


def episode(size: int, device) -> Batch:
    """Support and query smooth slices, the support's middle third as its
    label and a shifted square as the query's."""
    imgs = smooth_volume(2, size, seed=12)
    fg = np.zeros((1, 1, size, size), np.float32)
    q = size // 3
    fg[..., q:2 * q, q:2 * q] = 1
    lbl = np.zeros((1, size, size), np.int32)
    lbl[:, q + q // 4:2 * q + q // 4, q:2 * q] = 1
    return Batch.from_numpy((imgs[:1, None].numpy(), fg, 1 - fg,
                             imgs[1:, None].numpy(), lbl), device)


def run(model_name: str = "dinov2_l14", size: int = 672, steps: int = 3,
        top: int = 12, logdir: str = "runs/trace_train_step") -> dict:
    dev = require_cuda()
    cfg = Config(modelname=model_name, input_size=(size, size),
                 dtype="bfloat16", seed=0)
    model = build_coarse_model(cfg, dev)
    opt = make_optimizer(model.parameters())
    batch = episode(size, dev)
    for _ in range(2):
        train_step(model, opt, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        train_step(model, opt, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    logdir = pathlib.Path(logdir) / f"{model_name}_{size}"
    with trace(logdir) as prof:
        with annotate(RANGE):
            train_step(model, opt, batch)
            torch.cuda.synchronize()
    if _device_total_us(prof) <= 0:
        raise RuntimeError("torch.profiler recorded no CUDA time: the "
                           "trace did not reach the card")
    path = logdir / "trace.json"
    out = summarize(json.loads(path.read_text())["traceEvents"], top, RANGE)
    out.update(step_ms=statistics.median(walls), step_ms_runs=walls,
               trace=str(path))
    log(f"trace_train_step {model_name} {size}: isolated step "
        f"{out['step_ms']:.1f} ms (median of {walls}); traced step window "
        f"{out['window_ms']:.1f} ms, device busy {out['busy_ms']:.1f} ms, "
        f"idle share {100 * out['idle_share']:.1f}% over {out['kernels']} "
        f"device events; trace {path}")
    for k in out["top"]:
        log(f"  {k['ms']:9.2f} ms  x{k['calls']:<5d} "
            f"{100 * k['ms'] / out['busy_ms']:5.1f}%  {short_name(k['name'])}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dinov2_l14")
    ap.add_argument("--size", type=int, default=672)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--logdir", default="runs/trace_train_step")
    args = ap.parse_args(argv)
    return run(args.model, args.size, args.steps, args.top, args.logdir)


if __name__ == "__main__":
    main()
