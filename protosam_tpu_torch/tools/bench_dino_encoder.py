"""The DINOv2-L/14 encoder alone on the card: the counterpart of
``tools/bench_dino_encoder.py``.

DINOv2-L (24 blocks, 1024 wide, 16 heads) at 672 px, B = 8 slices, bf16
with seeded synthetic weights (``utils/synthetic.py``), on a seeded
N(0, 0.5²) input: the coarse stage's cost centre without the rest of the
pipeline.  Its block LayerNorms run on K1 and its attention on K2; the
launches of each per call are printed.  The JAX tool's ``blk_q`` argument
picks a block size of the TPU kernel and has no counterpart (K2's tiles are
fixed when it is compiled).

    python3 -m protosam_tpu_torch.tools.bench_dino_encoder [--reps 4]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from protosam_tpu_torch.models.dinov2.vit import build_dinov2
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.ops.attention import masked_flash_attention_packed
from protosam_tpu_torch.ops.norm import layer_norm_rows
from protosam_tpu_torch.tools.timing import device_ms, log, require_cuda
from protosam_tpu_torch.utils.synthetic import materialize


def run(reps: int = 4, batch: int = 8, image_size: int = 672) -> dict:
    dev = require_cuda()
    with torch.device("meta"):
        model = build_dinov2("dinov2_vitl14")
    cast_compute(materialize(model, dev, seed=0), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, 3, image_size, image_size), dtype=np.float32) * 0.5).to(dev)
    fwd = lambda: model(x)["x_norm_patchtokens"]
    with torch.no_grad():
        feats = fwd()
        if not torch.isfinite(feats).all():
            raise AssertionError("non-finite DINOv2 features")
        layer_norm_rows.launches = masked_flash_attention_packed.launches = 0
        fwd()
        launches = {"layer_norm_rows": layer_norm_rows.launches,
                    "packed_masked_attention":
                        masked_flash_attention_packed.launches}
        t = device_ms(fwd, reps=reps, runs=3)
    log(f"DINOv2-L/14 encoder, B={batch} at {image_size} px, bf16: {t} per "
        f"call = {t.median_ms / 24:.2f} ms per block, "
        f"{t.median_ms / batch:.2f} ms per slice; launches per call "
        f"{launches}")
    return {"ms": t.median_ms, "spread_ms": t.spread_ms,
            "launches": launches}


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
