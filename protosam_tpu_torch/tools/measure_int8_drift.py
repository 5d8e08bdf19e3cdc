"""How far the bf16 and int8 flagship's masks move from its f32 build, on
the card: the counterpart of ``tools/measure_bf16_drift.py --bench`` with
``DRIFT_INT8=1``.

Builds the flagship (DINOv2-L/14 at 672 px + SAM ViT-B) from the same
seeded synthetic weights four ways: ``f32`` (full f32 matmuls and
convolutions, no TF32), ``bf16``, ``int8`` (both encoders' dense stages on
kernels K8 and K9) and two splits that put int8 in one encoder only
(``int8 DINOv2`` with bf16 SAM, ``int8 SAM`` with bf16 DINOv2), runs
``forward_volume`` on the slices and support episode of ``chip_smoke.py``
phase 4, and prints per slice the Dice of each leg's masks against the f32
masks, of int8 against bf16, and the relative L2 distance of each leg's SAM
image embeddings from the f32 ones.  The splits say which encoder's int8
moves the masks.  ``--unit-norm2d`` loads every leg's SAM with
``utils.synthetic_state_dict(..., unit_norm2d=True)``: the same draws with
LayerNorm2d weights near 1, the role the port gave them before it took the
JAX recipe's 0.02·N.

    python3 -m protosam_tpu_torch.tools.measure_int8_drift [--slices 8]
        [--unit-norm2d]
"""

from __future__ import annotations

import argparse

import torch

from protosam_tpu_torch.tools.timing import log, require_cuda

IMAGE_SIZE = 672


def dice(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a > 0.5, b > 0.5
    den = (a.sum() + b.sum()).item()
    return 1.0 if den == 0 else 2.0 * (a & b).sum().item() / den


def run(n_slices: int = 8, slice_batch: int = 4,
        unit_norm2d: bool = False) -> dict:
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.pipeline.protosam import ProtoSAM
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode,
                                                    synthetic_state_dict)

    dev = require_cuda()
    vol = smooth_volume(n_slices, IMAGE_SIZE, seed=6).to(dev)
    built = {"f32": build_pipeline(dev, dtype=torch.float32),
             "bf16": build_pipeline(dev),
             "int8": build_pipeline(dev, quant_dense=True)}
    if unit_norm2d:  # build_pipeline's SAM seed is its seed 0 plus 1
        sd = synthetic_state_dict(built["f32"].sam_model, 1, unit_norm2d=True)
        for pipe in built.values():
            pipe.sam_model.load_state_dict(sd)
    cfg = built["bf16"].config
    legs = {**built,
            "int8 DINOv2": ProtoSAM(built["int8"].coarse_model,
                                    built["bf16"].sam_model, cfg),
            "int8 SAM": ProtoSAM(built["bf16"].coarse_model,
                                 built["int8"].sam_model, cfg)}
    masks, embeddings = {}, {}
    for name, pipe in legs.items():
        emb = []
        hook = pipe.sam_model.image_encoder.register_forward_hook(
            lambda m, i, out: emb.append(out.float()))
        try:
            preds, _ = pipe.forward_volume(
                vol, synthetic_episode(IMAGE_SIZE, dev, 7),
                slice_batch=slice_batch)
        finally:
            hook.remove()
        masks[name], embeddings[name] = preds, torch.cat(emb)
    out = {}
    pairs = [(name, "f32") for name in legs if name != "f32"]
    for a, b in pairs + [("int8", "bf16")]:
        dices = [dice(x, y) for x, y in zip(masks[a], masks[b])]
        ea, eb = embeddings[a], embeddings[b]
        rel = ((ea - eb).norm() / eb.norm()).item()
        mean = sum(dices) / len(dices)
        out[f"{a} vs {b}"] = {"dice": dices, "mean": mean, "min": min(dices),
                              "embedding_rel_l2": rel}
        log(f"int8 drift {a} vs {b}: mean Dice {mean:.5f}, min "
            f"{min(dices):.5f} (per slice "
            f"{[round(d, 5) for d in dices]}); SAM embedding rel L2 "
            f"{rel:.3e}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--unit-norm2d", action="store_true",
                    help="LayerNorm2d weights 1 + 0.02·N instead of 0.02·N")
    args = ap.parse_args(argv)
    return run(n_slices=args.slices, unit_norm2d=args.unit_norm2d)


if __name__ == "__main__":
    main()
