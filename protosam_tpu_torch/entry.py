"""The flagship slice pipeline: FewShotSeg DINOv2-L/14 at 672 px + SAM
ViT-B at 1024, bf16 with the f32 tails (DINOv2 final norm, ALP score, logit
upsample, prompt encoder and mask decoder), ``ProtoSAMConfig()`` defaults
(cca mode, both point modes, box prompts, ``max_ccs=8``) and synthetic
weights from a seed.  The counterpart of ``__graft_entry__._flagship`` with
int8 off.

    pipe = build_pipeline("cuda")
    preds, scores = pipe.forward_volume(queries, ALPNetInput(supp, fg, q0))
"""

from __future__ import annotations

import torch

from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.synthetic import materialize


def set_f32_precision() -> None:
    """Full-f32 matmuls and convolutions: the f32 tails match the JAX
    reference's ``highest`` matmul precision only without TF32 (cuDNN
    convolutions use TF32 by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_pipeline(device: torch.device | str, sam_ver: str = "vit_b",
                   coarse: str = "dinov2_l14", image_size: int = 672,
                   sam_size: int = 1024,
                   dtype: torch.dtype = torch.bfloat16,
                   config: ProtoSAMConfig | None = None,
                   seed: int = 0) -> ProtoSAM:
    """Both models built on the meta device, then allocated on ``device``
    with role-aware synthetic weights; the two encoders cast to ``dtype``
    (their norms keep f32 params), everything else stays f32."""
    set_f32_precision()
    with torch.device("meta"):
        coarse_model = FewShotSeg(image_size=image_size, which_model=coarse)
        sam = build_sam(sam_ver, image_size=sam_size)
    materialize(coarse_model, device, seed)
    materialize(sam, device, seed + 1)
    cast_compute(coarse_model.encoder, dtype)
    cast_compute(sam.image_encoder, dtype)
    config = config or ProtoSAMConfig(image_size=(sam_size, sam_size))
    return ProtoSAM(coarse_model, sam, config)
