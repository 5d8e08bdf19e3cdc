"""Where a slice's time goes, stage by stage, on the card: the counterpart
of ``tools/pipeline_profile.py``.

Builds a configuration (``flagship``: DINOv2-L/14 at 672 px + SAM ViT-B;
``flagship_int8``: the same with both encoders' dense stages on the int8
W8A8 path, kernels K8 and K9, the JAX entry point's default; ``vit_h``: the eval configuration with SAM ViT-H and the fused ALP, MLP and
projection routes, as ``chip_smoke.py`` phase 5 drives it;
``vit_h_unfused``: the same weights with the three routes off), runs
``forward_volume`` once to warm up, then once more with the five stage
methods of ``pipeline/protosam.py`` wrapped in the ``StageTimer`` (each
stage begins and ends with ``torch.cuda.synchronize``): the DINOv2
features (``FewShotSeg.get_features``), the ALP score
(``FewShotSeg.score``), ``_extract_prompts``, ``encode_image`` and
``_decode_stage``.  Then it times the whole ``forward_volume`` unwrapped,
host clock ending in a synchronize.  Inputs are smooth synthetic 672²
slices and a seeded support episode (``utils/synthetic.py``).

    python3 -m protosam_tpu_torch.tools.pipeline_profile
        [--config flagship|flagship_int8|vit_h|vit_h_unfused]
        [--slice-batch 4]
        [--slices 8] [--runs 3]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from protosam_tpu_torch.tools.timing import log, require_cuda
from protosam_tpu_torch.utils.profiling import StageTimer
from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                synthetic_episode)

CONFIGS = ("flagship", "flagship_int8", "vit_h", "vit_h_unfused")
IMAGE_SIZE = 672


def build_config(name: str, device: torch.device | str = "cuda"):
    """The pipeline of configuration ``name`` (see the module docstring)
    with seeded synthetic weights."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.eval.protosam_eval import build_models
    from protosam_tpu_torch.utils.config import Config

    if name in ("flagship", "flagship_int8"):
        return build_pipeline(device, quant_dense=name == "flagship_int8")
    if name not in CONFIGS:
        raise KeyError(f"unknown configuration {name!r}; have {CONFIGS}")
    fused = name == "vit_h"
    cfg = Config(modelname="dinov2_l14", input_size=(IMAGE_SIZE,) * 2,
                 protosam_sam_ver="sam_h", use_fused_alp=fused,
                 do_cca=True, dtype="bfloat16", max_ccs=8)
    return build_models(cfg, device=device, fused_mlp=fused,
                        fused_proj=fused)


def volume_inputs(n_slices: int, device, seed: int = 6):
    """(queries, episode): ``n_slices`` smooth slices and one support."""
    return (smooth_volume(n_slices, IMAGE_SIZE, seed).to(device),
            synthetic_episode(IMAGE_SIZE, device, seed + 1))


def stage_methods(pipe) -> dict:
    """Stage name -> (object, method name) for the five stages."""
    return {"DINOv2 get_features": (pipe.coarse_model, "get_features"),
            "ALP score": (pipe.coarse_model, "score"),
            "_extract_prompts": (pipe, "_extract_prompts"),
            "SAM encode_image": (pipe.sam_model, "encode_image"),
            "_decode_stage": (pipe, "_decode_stage")}


def _timed(timer: StageTimer, name: str, fn):
    def wrapped(*args, **kwargs):
        with timer.stage(name):
            return fn(*args, **kwargs)
    return wrapped


def run(config: str = "flagship", slice_batch: int = 4, n_slices: int = 8,
        runs: int = 3) -> dict:
    dev = require_cuda()
    t0 = time.perf_counter()
    pipe = build_config(config, dev)
    torch.cuda.synchronize()
    log(f"pipeline_profile {config}: built in "
        f"{time.perf_counter() - t0:.1f} s")
    vol, inp = volume_inputs(n_slices, dev)
    pipe.forward_volume(vol, inp, slice_batch=slice_batch)  # warm-up
    torch.cuda.synchronize()

    timer = StageTimer(dev)
    methods = stage_methods(pipe)
    for name, (obj, attr) in methods.items():
        setattr(obj, attr, _timed(timer, name, getattr(obj, attr)))
    t0 = time.perf_counter()
    try:
        pipe.forward_volume(vol, inp, slice_batch=slice_batch)
        torch.cuda.synchronize()
    finally:
        for obj, attr in methods.values():
            delattr(obj, attr)  # back to the class's method
    staged = (time.perf_counter() - t0) * 1e3
    log(f"pipeline_profile {config}, {n_slices} slices at slice_batch "
        f"{slice_batch}, stages synchronized: forward_volume {staged:.1f} "
        f"ms, of which\n{timer.report()}")

    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        pipe.forward_volume(vol, inp, slice_batch=slice_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n_slices * 1e3)
    log(f"pipeline_profile {config}: forward_volume unwrapped "
        f"{statistics.median(walls):.2f} ms/slice median of {runs} "
        f"(runs {[round(w, 2) for w in walls]})")
    return {"stages": timer.as_dict(), "staged_ms": staged,
            "ms_per_slice": walls}


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship", choices=CONFIGS)
    ap.add_argument("--slice-batch", type=int, default=4)
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    return run(args.config, args.slice_batch, args.slices, args.runs)


if __name__ == "__main__":
    main()
