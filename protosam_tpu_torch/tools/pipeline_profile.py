"""Where a slice's time goes, stage by stage, on the card: the counterpart
of ``tools/pipeline_profile.py``.

Builds a configuration (``flagship``: DINOv2-L/14 at 672 px + SAM ViT-B;
``flagship_int8``: the same with both encoders' dense stages on the int8
W8A8 path, kernels K8 and K9, the JAX entry point's default; ``vit_h``: the eval configuration with SAM ViT-H and the fused ALP, MLP and
projection routes, as ``chip_smoke.py`` phase 5 drives it;
``vit_h_unfused``: the same weights with the three routes off;
``g14_vitb``: DINOv2 ViT-g/14, the gated FFN, at 672 px with SAM ViT-B), runs
``forward_volume`` once to warm up, then once more with tracing enabled
(``utils/profiling.enable``) and reports the program's own spans of that
volume (``stage_trace``): the five stages, ``pipeline.support_encode``
(DINOv2 on the support), ``pipeline.coarse`` (DINOv2 features and the ALP
score of a batch), ``pipeline.prompts`` (``_extract_prompts``),
``pipeline.sam_encoder`` (``encode_image``) and ``pipeline.decode``
(``_decode_stage``), and inside the coarse encoder ``dinov2.encode`` and
``dinov2.ffn``, each with its host ms and its device ms from CUDA
events on the stream (nothing synchronizes between stages), the FFN's
share of the encoder's device ms, and the
counts on the volume's span (``volume_counts``): the slices, the padded
ones and each kernel's launches a slice (K1-K9).  Then it
times the whole ``forward_volume`` with tracing off, host clock ending in
a synchronize.  Inputs are smooth synthetic 672² slices and a seeded
support episode (``utils/synthetic.py``).

    python3 -m protosam_tpu_torch.tools.pipeline_profile
        [--config flagship|flagship_int8|vit_h|vit_h_unfused|g14_vitb]
        [--slice-batch 4]
        [--slices 8] [--runs 3]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from protosam_tpu_torch.tools.timing import log, require_cuda
from protosam_tpu_torch.utils import profiling
from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                synthetic_episode)

CONFIGS = ("flagship", "flagship_int8", "vit_h", "vit_h_unfused",
           "g14_vitb")
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
    g14 = name == "g14_vitb"
    cfg = Config(modelname="dinov2_g14" if g14 else "dinov2_l14",
                 input_size=(IMAGE_SIZE,) * 2,
                 protosam_sam_ver="sam_b" if g14 else "sam_h",
                 use_fused_alp=fused, do_cca=True, dtype="bfloat16",
                 max_ccs=8)
    return build_models(cfg, device=device, fused_mlp=fused,
                        fused_proj=fused)


def volume_inputs(n_slices: int, device, seed: int = 6):
    """(queries, episode): ``n_slices`` smooth slices and one support."""
    return (smooth_volume(n_slices, IMAGE_SIZE, seed).to(device),
            synthetic_episode(IMAGE_SIZE, device, seed + 1))


def stage_trace(pipe, vol, inp, slice_batch: int) -> dict:
    """One ``forward_volume`` with tracing enabled: ``profiling.summary``
    of its spans (``pipeline.volume`` and the five stages)."""
    was = profiling.enabled()
    profiling.enable()
    try:
        pipe.forward_volume(vol, inp, slice_batch=slice_batch)
    finally:
        profiling.enable(was)
    volume = next(s for s in reversed(profiling.spans())
                  if s.name == "pipeline.volume")
    return profiling.summary(profiling.spans(within=volume))


def ffn_share(stages: dict) -> float | None:
    """From ``stage_trace``'s table: the ``dinov2.ffn`` spans' device ms
    over the ``dinov2.encode`` spans', in percent (None without device
    times)."""
    enc, ffn = stages.get("dinov2.encode", {}), stages.get("dinov2.ffn", {})
    if not enc.get("device_ms") or "device_ms" not in ffn:
        return None
    return 100.0 * ffn["device_ms"] / enc["device_ms"]


def volume_counts(stages: dict) -> dict:
    """From ``stage_trace``'s table: the volume's ``slices``, its
    ``padded`` slices and ``launches_per_slice`` of each kernel that
    launched (none on the CPU)."""
    counts = stages["pipeline.volume"]["counts"]
    n = counts["slices"]
    return {"slices": n, "padded": counts["padded"],
            "launches_per_slice": {
                k.split(".", 1)[1]: v / n for k, v in counts.items()
                if k.startswith("launches.")}}


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

    stages = stage_trace(pipe, vol, inp, slice_batch)
    log(f"pipeline_profile {config}, {n_slices} slices at slice_batch "
        f"{slice_batch}, traced: forward_volume "
        f"{stages['pipeline.volume']['total_ms']:.1f} ms host, of which\n"
        f"{profiling.report(stages)}")
    share = ffn_share(stages)
    if share is not None:
        log(f"pipeline_profile {config}: dinov2.ffn {share:.2f}% of "
            f"dinov2.encode's device ms")
    vc = volume_counts(stages)
    log(f"pipeline_profile {config}: {vc['slices']} slices, {vc['padded']} "
        f"padded; kernel launches a slice "
        f"{ {k: round(v, 3) for k, v in vc['launches_per_slice'].items()} }")

    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        pipe.forward_volume(vol, inp, slice_batch=slice_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n_slices * 1e3)
    log(f"pipeline_profile {config}: forward_volume untraced "
        f"{statistics.median(walls):.2f} ms/slice median of {runs} "
        f"(runs {[round(w, 2) for w in walls]})")
    return {"stages": stages, "volume": vc, "ffn_share": share,
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
