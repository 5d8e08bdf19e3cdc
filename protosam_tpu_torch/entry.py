"""Build the ProtoSAM slice pipeline: FewShotSeg DINOv2 at 672 px + SAM at
1024, bf16 with the f32 tails (DINOv2 final norm, ALP score, logit
upsample, prompt encoder and mask decoder), ``ProtoSAMConfig()`` defaults
(cca mode, both point modes, box prompts, ``max_ccs=8``) and synthetic
weights from a seed.  The defaults are the flagship, the counterpart of
``__graft_entry__._flagship`` with int8 off (SAM ViT-B); ``quant_dense=True``
is that entry's default, the int8 W8A8 dense stages in both encoders
(kernels K8 and K9).  The ViT-H refine configuration sets
``sam_ver="vit_h"`` and the three fused routes
(``eval.protosam_eval.build_models`` maps the eval ``Config`` here).

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
                   seed: int = 0, proto_grid_size: int = 8,
                   use_fused_alp: bool = False, fused_mlp: bool = False,
                   fused_proj: bool = False, quant_dense: bool = False,
                   coarse_state: dict | None = None,
                   sam_state: dict | None = None) -> ProtoSAM:
    """Both models built on the meta device, then allocated on ``device``
    with role-aware synthetic weights, or with ``coarse_state`` /
    ``sam_state`` where given (reference-layout state_dicts, loaded
    strictly: a missing or unexpected key raises and is named); the two
    encoders cast to ``dtype`` (their norms keep f32 params), everything
    else stays f32.
    ``use_fused_alp`` puts the ALP matching on kernel K5, ``fused_mlp`` /
    ``fused_proj`` the bf16 SAM encoder's MLP / projection on K7 / K6,
    ``quant_dense`` both encoders' dense stages on the int8 path (K8 and
    K9; their params stay f32, and the two SAM routes turn off)."""
    set_f32_precision()
    with torch.device("meta"):
        coarse_model = FewShotSeg(image_size=image_size, which_model=coarse,
                                  proto_grid_size=proto_grid_size,
                                  use_fused_alp=use_fused_alp,
                                  quant_dense=quant_dense)
        sam = build_sam(sam_ver, image_size=sam_size, fused_mlp=fused_mlp,
                        fused_proj=fused_proj, quant_dense=quant_dense)
    _allocate(coarse_model, device, seed, coarse_state)
    _allocate(sam, device, seed + 1, sam_state)
    cast_compute(coarse_model.encoder, dtype)
    cast_compute(sam.image_encoder, dtype)
    config = config or ProtoSAMConfig(image_size=(sam_size, sam_size))
    return ProtoSAM(coarse_model, sam, config)


def _allocate(module: torch.nn.Module, device: torch.device | str,
              seed: int, state_dict: dict | None) -> None:
    if state_dict is None:
        materialize(module, device, seed)
        return
    module.to_empty(device=device)
    module.load_state_dict(state_dict)
    module.eval()
