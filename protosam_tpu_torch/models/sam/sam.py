"""SAM: image encoder + prompt encoder + mask decoder with a fixed square
frame (reference models/segment_anything/modeling/sam.py and the pip
predictor flow the pipeline drives)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from protosam_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from protosam_tpu_torch.models.sam.mask_decoder import MaskDecoder
from protosam_tpu_torch.models.sam.prompt_encoder import PromptEncoder

DEFAULT_PIXEL_MEAN = (123.675, 116.28, 103.53)
DEFAULT_PIXEL_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    def __init__(self, encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12,
                 encoder_global_attn_indexes: tuple = (2, 5, 8, 11),
                 prompt_embed_dim: int = 256, image_size: int = 1024,
                 vit_patch_size: int = 16, fused_mlp: bool = False,
                 fused_proj: bool = False, quant_dense: bool = False):
        super().__init__()
        grid = image_size // vit_patch_size
        self.image_size = image_size
        self.vit_patch_size = vit_patch_size
        self.encoder_global_attn_indexes = tuple(encoder_global_attn_indexes)
        self.image_encoder = ImageEncoderViT(
            img_size=image_size, patch_size=vit_patch_size,
            embed_dim=encoder_embed_dim, depth=encoder_depth,
            num_heads=encoder_num_heads, out_chans=prompt_embed_dim,
            window_size=14, global_attn_indexes=encoder_global_attn_indexes,
            fused_mlp=fused_mlp, fused_proj=fused_proj,
            quant_dense=quant_dense)
        # the decode tail keeps nn.Linear: it is never quantized (JAX
        # sam.py:54-57)
        self.prompt_encoder = PromptEncoder(
            embed_dim=prompt_embed_dim, image_embedding_size=(grid, grid),
            input_image_size=(image_size, image_size), mask_in_chans=16)
        self.mask_decoder = MaskDecoder(transformer_dim=prompt_embed_dim)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) preprocessed -> (B, 256, H/16, W/16)."""
        return self.image_encoder(x)

    def decode(self, image_embedding: torch.Tensor, coords: torch.Tensor,
               labels: torch.Tensor, boxes: torch.Tensor | None = None,
               mask_inputs: torch.Tensor | None = None,
               multimask_output: bool = True, pad_points: bool = True):
        """One embedding row per prompt set (or one shared row): coords
        (B, P, 2), labels (B, P), boxes (B, 4) | None, mask_inputs
        (B, 1, 4h, 4w) | None.  Returns (low_res (B, M, 4h, 4w), iou (B, M))
        in f32."""
        image_embedding = image_embedding.float()
        sparse, dense = self.prompt_encoder(coords, labels, boxes,
                                            mask_inputs, pad_points)
        b = sparse.shape[0]
        if image_embedding.shape[0] == 1 and b > 1:
            image_embedding = image_embedding.expand(b, -1, -1, -1)
        return self.mask_decoder(image_embedding,
                                 self.prompt_encoder.get_dense_pe(), sparse,
                                 dense, multimask_output)


def preprocess(x: torch.Tensor, img_size: int = 1024,
               pixel_mean=DEFAULT_PIXEL_MEAN,
               pixel_std=DEFAULT_PIXEL_STD) -> torch.Tensor:
    """Normalise (B, 3, H, W) pixels and zero-pad bottom/right to the square
    encoder frame (reference sam.py:163-173)."""
    mean = torch.tensor(pixel_mean, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(pixel_std, device=x.device).reshape(1, 3, 1, 1)
    x = (x - mean) / std
    h, w = x.shape[-2:]
    return F.pad(x, (0, img_size - w, 0, img_size - h))
