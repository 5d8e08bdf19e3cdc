"""SAM model registry (reference models/segment_anything/build_sam.py).

vit_b: 768×12, 12 heads, global blocks (2, 5, 8, 11); vit_t is a test-size
model that the reference does not have.
"""

from __future__ import annotations

from protosam_tpu_torch.models.sam.sam import Sam

_CONFIGS = {
    "vit_b": dict(encoder_embed_dim=768, encoder_depth=12,
                  encoder_num_heads=12,
                  encoder_global_attn_indexes=(2, 5, 8, 11)),
    "vit_t": dict(encoder_embed_dim=160, encoder_depth=2,
                  encoder_num_heads=4, encoder_global_attn_indexes=(1,)),
}


def build_sam(model_type: str = "vit_b", image_size: int = 1024) -> Sam:
    if model_type not in _CONFIGS:
        raise KeyError(f"unknown SAM model type {model_type!r}; "
                       f"have {sorted(_CONFIGS)}")
    return Sam(image_size=image_size, **_CONFIGS[model_type])
