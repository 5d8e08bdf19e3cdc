"""SAM prompt encoder, batched over prompt sets with static shapes
(reference models/segment_anything/modeling/prompt_encoder.py).

Every prompt set is a fixed-size padded point list (label -1 marks padding,
the reference's "not a point" convention) plus an optional box slot, so one
call serves every component count.  Dense outputs are NCHW.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from protosam_tpu_torch.models.layers import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (prompt_encoder.py:171-214)."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn((2, num_pos_feats)))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """(..., 2) in [0, 1] -> (..., 2·num_pos_feats)."""
        c = 2.0 * coords01.float() - 1.0
        c = 2.0 * math.pi * (c @ self.positional_encoding_gaussian_matrix
                             .float())
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, size: tuple[int, int]) -> torch.Tensor:
        """Dense PE of an (h, w) grid at pixel centres -> (C, h, w)."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return self(torch.stack([xx, yy], dim=-1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: tuple[int, int] = (64, 64),
                 input_image_size: tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # [neg point, pos point, box top-left, box bottom-right]
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))
        # assigned after mask_downscaling, as in the reference, so that the
        # state_dict lists the keys in the reference's order
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def _pe_points(self, coords: torch.Tensor) -> torch.Tensor:
        size = torch.tensor([self.input_image_size[1],
                             self.input_image_size[0]], dtype=torch.float32,
                            device=coords.device)
        return self.pe_layer(coords.float() / size)

    def embed_points(self, coords: torch.Tensor, labels: torch.Tensor,
                     pad: bool = True) -> torch.Tensor:
        """coords (N, P, 2) xy pixels; labels (N, P) in {1, 0, -1}; with
        ``pad`` a (0, 0)/-1 row is appended, as the reference does when no
        box accompanies the points."""
        if pad:
            n = coords.shape[0]
            coords = torch.cat([coords, coords.new_zeros(n, 1, 2)], dim=1)
            labels = torch.cat([labels, labels.new_full((n, 1), -1)], dim=1)
        pe = self._pe_points(coords + 0.5)
        lab = labels[..., None]
        pe = torch.where(lab == -1, 0.0, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed.weight[0], 0.0)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].weight[0],
                              0.0)
        pe = pe + torch.where(lab == 1, self.point_embeddings[1].weight[0],
                              0.0)
        return pe

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (N, 4) xyxy -> (N, 2, C) corner embeddings."""
        pe = self._pe_points(boxes.reshape(-1, 2, 2) + 0.5)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return pe + corner

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (N, 1, H, W) -> (N, C, H/4, W/4)."""
        return self.mask_downscaling(masks)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, C, h, w) dense positional encoding of the embedding grid."""
        return self.pe_layer.grid(self.image_embedding_size)[None]

    def forward(self, coords: torch.Tensor, labels: torch.Tensor,
                boxes: torch.Tensor | None = None,
                masks: torch.Tensor | None = None,
                pad_points: bool = True):
        """Returns (sparse (N, T, C), dense (N, C, h, w))."""
        sparse = self.embed_points(coords, labels,
                                   pad=pad_points and boxes is None)
        if boxes is not None:
            sparse = torch.cat([sparse, self.embed_boxes(boxes)], dim=1)
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
                coords.shape[0], -1, h, w)
        return sparse, dense
