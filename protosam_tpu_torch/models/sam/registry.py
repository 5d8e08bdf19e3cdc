"""SAM model registry (reference models/segment_anything/build_sam.py:14-107).

vit_h: 1280×32, 16 heads, global blocks (7, 15, 23, 31)
vit_l: 1024×24, 16 heads, global blocks (5, 11, 17, 23)
vit_b:  768×12, 12 heads, global blocks (2, 5, 8, 11)
vit_t is a test-size model that the reference does not have.
"""

from __future__ import annotations

from protosam_tpu_torch.models.sam.sam import Sam

_CONFIGS = {
    "vit_h": dict(encoder_embed_dim=1280, encoder_depth=32,
                  encoder_num_heads=16,
                  encoder_global_attn_indexes=(7, 15, 23, 31)),
    "vit_l": dict(encoder_embed_dim=1024, encoder_depth=24,
                  encoder_num_heads=16,
                  encoder_global_attn_indexes=(5, 11, 17, 23)),
    "vit_b": dict(encoder_embed_dim=768, encoder_depth=12,
                  encoder_num_heads=12,
                  encoder_global_attn_indexes=(2, 5, 8, 11)),
    "vit_t": dict(encoder_embed_dim=160, encoder_depth=2,
                  encoder_num_heads=4, encoder_global_attn_indexes=(1,)),
}


def build_sam(model_type: str = "vit_b", image_size: int = 1024,
              fused_mlp: bool = False, fused_proj: bool = False,
              quant_dense: bool = False) -> Sam:
    """``fused_mlp`` / ``fused_proj`` put the encoder's bf16 MLP and
    attention projection on kernels K7 / K6 (the JAX package's
    ``PTPU_MLP_PALLAS`` / ``PTPU_PROJ_PALLAS``; off by default there too).
    ``quant_dense`` makes the image encoder's dense stages int8 (kernels K8
    and K9) and turns both routes off; the prompt encoder and the mask
    decoder are never quantized."""
    if model_type not in _CONFIGS:
        raise KeyError(f"unknown SAM model type {model_type!r}; "
                       f"have {sorted(_CONFIGS)}")
    return Sam(image_size=image_size, fused_mlp=fused_mlp,
               fused_proj=fused_proj, quant_dense=quant_dense,
               **_CONFIGS[model_type])
