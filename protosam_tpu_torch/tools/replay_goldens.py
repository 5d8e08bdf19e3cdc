"""Replay the recorded reference masks through the port's refine path on
the card, in f32 and in bf16: the counterpart of
``tools/replay_goldens_onchip.py``.

``tests/goldens/ref_masks/`` holds 36 masks, 6 prompt configurations × 6
slices, recorded from the PyTorch reference's ``ProtoSAM.forward``
(models/ProtoSAM.py:536-678) on a seeded tiny SAM and deterministic
inputs.  ``tests/test_torch_goldens.py`` replays them on the CPU, where
only the plain versions of the kernels run; this tool rebuilds the same
tiny SAM (``utils/synthetic.seeded_tiny_sam``) on the card, where K1, K3
and K4 run, and records per configuration the min and mean Dice against
the recorded masks, f32 and bf16 (the encoder in bf16, the decode tail
f32), and the bf16-vs-f32 drift.

    python3 -m protosam_tpu_torch.tools.replay_goldens [--out FILE.json]
        [--bf16-floor 0.97] [--configs cca,all] [--device cuda]

Prints one JSON line; exits 1 if f32 falls below Dice 0.99 on any
configuration or bf16 below ``--bf16-floor`` (JAX's bars).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.synthetic import (seeded_tiny_sam,
                                                synthetic_agreement_case)

GOLDEN_DIR = (pathlib.Path(__file__).resolve().parents[2] / "tests"
              / "goldens" / "ref_masks")
F32_BAR = 0.99


def _dice(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else float(2.0 * np.logical_and(a, b).sum()
                                      / den)


def replay(tag: str, cfg: dict, dtype: torch.dtype, device) -> list:
    """The masks of one recorded configuration, its 6 slices through
    ``_refine_core`` on ``device`` with the encoder in ``dtype``."""
    sam = seeded_tiny_sam(device)
    cast_compute(sam.image_encoder, dtype)
    pipe = ProtoSAM(None, sam, ProtoSAMConfig(
        image_size=(256, 256), max_ccs=8, use_cca=cfg["use_cca"],
        use_points=cfg["use_points"], use_bbox=cfg["use_bbox"],
        use_mask=cfg["use_mask"], use_neg_points=cfg["use_neg_points"],
        point_mode=cfg["point_mode"],
        num_points_for_sam=cfg["num_points_for_sam"],
        # recorded through the reference's uint8 cast of the mask prompt
        mask_prompt_uint8_wrap=cfg["use_mask"]))
    masks = []
    with torch.no_grad():
        for i in range(len(cfg["files"])):
            qry, logits = synthetic_agreement_case(i)
            pred, _ = pipe._refine_core(torch.from_numpy(qry).to(device),
                                        torch.from_numpy(logits).to(device))
            masks.append(pred[0].cpu().numpy() > 0)
    return masks


def _stats(d: list[float]) -> dict:
    return {"min": min(d), "mean": sum(d) / len(d)}


def run(configs: list[str] | None = None, bf16_floor: float = 0.97,
        device: str = "cuda") -> dict:
    """Every recorded configuration (or ``configs``) in f32 and bf16 on
    ``device``: per configuration the Dice against the recorded masks and
    the bf16-vs-f32 drift, and ``passes``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        set_f32_precision()  # the f32 leg in full f32: no TF32
    manifest = json.loads((GOLDEN_DIR / "manifest.json").read_text())
    result = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "configs": {}}
    ok = True
    for tag in configs or list(manifest["configs"]):
        cfg = manifest["configs"][tag]
        ref = [np.load(GOLDEN_DIR / name) for name in cfg["files"]]
        preds = {name: replay(tag, cfg, dt, dev) for name, dt in
                 (("f32", torch.float32), ("bf16", torch.bfloat16))}
        row = {f"{name}_vs_reference": _stats(
                   [_dice(a, b) for a, b in zip(preds[name], ref)])
               for name in ("f32", "bf16")}
        row["bf16_vs_f32"] = _stats([_dice(a, b) for a, b in
                                     zip(preds["bf16"], preds["f32"])])
        result["configs"][tag] = row
        f32_min = row["f32_vs_reference"]["min"]
        bf16_min = row["bf16_vs_reference"]["min"]
        ok &= f32_min >= F32_BAR and bf16_min >= bf16_floor
        print(f"{tag}: f32 min {f32_min:.6f}, bf16 min {bf16_min:.6f}, "
              f"drift min {row['bf16_vs_f32']['min']:.6f}", file=sys.stderr,
              flush=True)
    result["passes"] = bool(ok)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the JSON line here too")
    ap.add_argument("--bf16-floor", type=float, default=0.97)
    ap.add_argument("--configs", default=None,
                    help="comma list (default: every recorded config)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.configs.split(",") if args.configs else None,
                 args.bf16_floor, args.device)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0 if result["passes"] else 1


if __name__ == "__main__":
    sys.exit(main())
