"""DINOv2 vision transformer (frozen feature extractor), hub state_dict
layout: ViT with 14-px patches, cls token (+ optional registers),
LayerScale, pre-norm blocks and bicubic pos-embed interpolation.

The reference consumes ``forward_features(...)["x_norm_patchtokens"]``
(grid_proto_fewshot.py:90-98).  Attention runs on kernel K2 straight from
the packed qkv projection; the block LayerNorms run on kernel K1.
``quant_dense`` makes the blocks' qkv, proj, fc1 and fc2 int8 layers
(``ops/quant.QuantLinear``, kernels K8 and K9), JAX ``vit.py:50-64,111-130``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from protosam_tpu_torch.models.layers import (TokenLayerNorm, cast_compute,
                                              gelu_for)
from protosam_tpu_torch.ops.attention import masked_flash_attention_packed
from protosam_tpu_torch.ops.quant import dense_cls
from protosam_tpu_torch.ops.resize import resize_bicubic_torch


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, quant_dense: bool = False):
        super().__init__()
        linear = dense_cls(quant_dense)
        self.num_heads = num_heads
        self.qkv = linear(dim, 3 * dim)
        self.proj = linear(dim, dim)

    def forward(self, x: torch.Tensor,
                valid_tokens: int | None) -> torch.Tensor:
        hd = x.shape[-1] // self.num_heads
        out = masked_flash_attention_packed(
            self.qkv(x), scale=hd ** -0.5, num_heads=self.num_heads,
            n_valid=valid_tokens)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, quant_dense: bool = False):
        super().__init__()
        linear = dense_cls(quant_dense)
        self.fc1 = linear(dim, hidden)
        self.fc2 = linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_for(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 quant_dense: bool = False):
        super().__init__()
        self.norm1 = TokenLayerNorm(dim, 1e-6)
        self.attn = Attention(dim, num_heads, quant_dense)
        self.ls1 = LayerScale(dim)
        self.norm2 = TokenLayerNorm(dim, 1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), quant_dense)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor,
                valid_tokens: int | None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), valid_tokens))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 pos_embed_size: int = 37,
                 interpolate_antialias: bool = False,
                 interpolate_offset: float = 0.1, quant_dense: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_embed_size = pos_embed_size
        self.num_register_tokens = num_register_tokens
        self.interpolate_antialias = interpolate_antialias
        self.interpolate_offset = interpolate_offset
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_embed_size ** 2, embed_dim))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, embed_dim))
        # unused at inference; kept so hub checkpoints load as they are
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size,
                                          patch_size)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, quant_dense)
            for _ in range(depth))
        # f32 even under a bf16 build: it feeds the ALP cosine match whose
        # argmax seeds CCA and every SAM prompt (the f32 coarse tail)
        self.norm = TokenLayerNorm(embed_dim, 1e-6, out_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, 3, H, W), H/W divisible by the patch size.  Returns
        ``x_norm_clstoken`` (B, C), ``x_norm_regtokens``,
        ``x_norm_patchtokens`` (B, N, C), all f32."""
        b, _, h, w = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        dt = self.patch_embed.proj.weight.dtype
        x = self.patch_embed.proj(x.to(dt)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = x + self._interpolate_pos_encoding(gh, gw).to(dt)
        if self.num_register_tokens:
            x = torch.cat([x[:, :1],
                           self.register_tokens.to(dt).expand(b, -1, -1),
                           x[:, 1:]], dim=1)
        # pad the sequence once to a 128 multiple and mask the pad keys in
        # every layer (small test-size sequences are not padded)
        n_tokens = x.shape[1]
        n_pad = (-n_tokens) % 128 if n_tokens >= 2048 else 0
        if n_pad:
            x = nn.functional.pad(x, (0, 0, 0, n_pad))
        valid = n_tokens if n_pad else None
        for blk in self.blocks:
            x = blk(x, valid)
        x = self.norm(x[:, :n_tokens])
        r = self.num_register_tokens
        return {"x_norm_clstoken": x[:, 0],
                "x_norm_regtokens": x[:, 1:1 + r],
                "x_norm_patchtokens": x[:, 1 + r:]}

    def _interpolate_pos_encoding(self, gh: int, gw: int) -> torch.Tensor:
        """Torch bicubic resize of the pretrain pos-embed grid to (gh, gw),
        hub ``interpolate_pos_encoding`` semantics (with
        ``interpolate_offset`` the scale-factor call mode)."""
        m = self.pos_embed_size
        pe = self.pos_embed.float()
        cls_pe, patch_pe = pe[:, :1], pe[:, 1:]
        if (gh, gw) == (m, m):
            return pe
        grid = patch_pe.reshape(1, m, m, -1).permute(0, 3, 1, 2)
        scales = None
        if self.interpolate_offset:
            scales = (m / (gh + self.interpolate_offset),
                      m / (gw + self.interpolate_offset))
        grid = resize_bicubic_torch(grid, (gh, gw), scales=scales,
                                    antialias=self.interpolate_antialias)
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([cls_pe, grid], dim=1)


_DINO_CONFIGS: dict[str, dict[str, Any]] = {
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": dict(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14": dict(embed_dim=1024, depth=24, num_heads=16),
    "dinov2_vits14_reg": dict(embed_dim=384, depth=12, num_heads=6,
                              num_register_tokens=4,
                              interpolate_antialias=True,
                              interpolate_offset=0.0),
    "dinov2_vitb14_reg": dict(embed_dim=768, depth=12, num_heads=12,
                              num_register_tokens=4,
                              interpolate_antialias=True,
                              interpolate_offset=0.0),
    "dinov2_vitl14_reg": dict(embed_dim=1024, depth=24, num_heads=16,
                              num_register_tokens=4,
                              interpolate_antialias=True,
                              interpolate_offset=0.0),
    # test-size model for CPU-runnable configs
    "dinov2_vitt14": dict(embed_dim=64, depth=2, num_heads=2),
}


def build_dinov2(name: str,
                 quant_dense: bool = False) -> DinoVisionTransformer:
    if name not in _DINO_CONFIGS:
        raise KeyError(f"unknown DINOv2 variant {name!r}; "
                       f"have {sorted(_DINO_CONFIGS)}")
    return DinoVisionTransformer(quant_dense=quant_dense,
                                 **_DINO_CONFIGS[name])


__all__ = ["DinoVisionTransformer", "build_dinov2", "cast_compute"]
