"""The SAM ViTDet image encoder alone on the card: the counterpart of
``tools/bench_sam_encoder.py``.

SAM's encoder at 1024², B = 8, bf16 with seeded synthetic weights, on a
seeded N(0, 0.5²) input.  ``--sam-ver`` picks the model; in place of the
JAX tool's TPU backend arguments (window/global lowerings, window columns
per program, scoped VMEM) it takes the port's two encoder routes:
``--fused-mlp`` (the MLP with its residual on K7) and ``--fused-proj`` (the
attention projection with its residual on K6).  Attention always runs on
K4 and the block LayerNorms on K1; the launches of each kernel per call are
printed.

    python3 -m protosam_tpu_torch.tools.bench_sam_encoder [--reps 3]
        [--sam-ver vit_b] [--fused-mlp] [--fused-proj]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.ops.mlp import dense_residual, mlp_fused
from protosam_tpu_torch.ops.norm import layer_norm_rows
from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention
from protosam_tpu_torch.tools.timing import device_ms, log, require_cuda
from protosam_tpu_torch.utils.synthetic import materialize

WRAPPERS = {"layer_norm_rows": layer_norm_rows,
            "relpos_patch_attention": relpos_patch_attention,
            "dense_residual": dense_residual, "mlp_fused": mlp_fused}


def run(reps: int = 3, sam_ver: str = "vit_b", fused_mlp: bool = False,
        fused_proj: bool = False, batch: int = 8) -> dict:
    dev = require_cuda()
    with torch.device("meta"):
        sam = build_sam(sam_ver, fused_mlp=fused_mlp, fused_proj=fused_proj)
    materialize(sam, dev, seed=1)
    enc = cast_compute(sam.image_encoder, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, 3, sam.image_size, sam.image_size), dtype=np.float32)
        * 0.5).to(dev)
    with torch.no_grad():
        if not torch.isfinite(enc(x).float()).all():
            raise AssertionError("non-finite SAM embeddings")
        for fn in WRAPPERS.values():
            fn.launches = 0
        enc(x)
        launches = {k: fn.launches for k, fn in WRAPPERS.items()}
        t = device_ms(lambda: enc(x), reps=reps, runs=3)
    log(f"SAM {sam_ver} encoder, B={batch} at {sam.image_size}, bf16, "
        f"fused_mlp={fused_mlp} fused_proj={fused_proj}: {t} per call = "
        f"{t.median_ms / batch:.2f} ms per slice; launches per call "
        f"{launches}")
    return {"ms": t.median_ms, "spread_ms": t.spread_ms,
            "launches": launches}


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sam-ver", default="vit_b")
    ap.add_argument("--fused-mlp", action="store_true")
    ap.add_argument("--fused-proj", action="store_true")
    args = ap.parse_args(argv)
    return run(reps=args.reps, sam_ver=args.sam_ver,
               fused_mlp=args.fused_mlp, fused_proj=args.fused_proj)


if __name__ == "__main__":
    main()
