"""SAM mask decoder (reference models/segment_anything/modeling/
mask_decoder.py), run batched over every component of every slice at once.
The caller passes one image-embedding row per prompt set."""

from __future__ import annotations

import torch
from torch import nn

from protosam_tpu_torch.models.layers import MLP, LayerNorm2d
from protosam_tpu_torch.models.sam.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256):
        super().__init__()
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(2, transformer_dim, 8, 2048)
        self.iou_token = nn.Embedding(1, transformer_dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, transformer_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(transformer_dim, transformer_dim // 4, 2, 2),
            LayerNorm2d(transformer_dim // 4), nn.GELU(),
            nn.ConvTranspose2d(transformer_dim // 4, transformer_dim // 8, 2,
                               2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(transformer_dim, transformer_dim, transformer_dim // 8, 3)
            for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(transformer_dim, iou_head_hidden_dim,
                                       self.num_mask_tokens, iou_head_depth)

    def forward(self, image_embeddings: torch.Tensor,
                image_pe: torch.Tensor, sparse_prompt_embeddings: torch.Tensor,
                dense_prompt_embeddings: torch.Tensor,
                multimask_output: bool):
        """image_embeddings, dense (B, C, h, w); image_pe (1, C, h, w);
        sparse (B, N, C).  Returns (masks (B, M, 4h, 4w), iou (B, M))."""
        b = sparse_prompt_embeddings.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1),
                            sparse_prompt_embeddings], dim=1)
        src = image_embeddings + dense_prompt_embeddings
        _, c, h, w = src.shape
        hs, src = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]
        src = src.transpose(1, 2).reshape(b, c, h, w)
        upscaled = self.output_upscaling(src)           # (B, C/8, 4h, 4w)
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)],
                               dim=1)                    # (B, M, C/8)
        masks = (hyper_in @ upscaled.flatten(2)).reshape(
            b, -1, *upscaled.shape[-2:])
        iou_pred = self.iou_prediction_head(iou_token_out)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
