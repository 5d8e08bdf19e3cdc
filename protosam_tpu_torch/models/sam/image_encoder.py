"""SAM image encoder (ViTDet), reference state_dict layout
(models/segment_anything/modeling/image_encoder.py).

Each block projects qkv once on the full grid; windowed blocks pad the
projection (not the input) to a window multiple, so pad tokens carry the
qkv bias exactly as the reference's zero-padded input does after its
projection.  Both attention kinds run on kernel K4 from the packed qkv plus
the compact decomposed rel-pos bias; the block LayerNorms run on kernel K1.

``fused_proj`` / ``fused_mlp`` (the JAX package's ``PTPU_PROJ_PALLAS`` /
``PTPU_MLP_PALLAS``) run the attention projection with its residual on
kernel K6 and the MLP with its residual on kernel K7.  They apply only to
bf16 activations; under f32 a block keeps the plain composition, the JAX
rule at ``image_encoder.py:429-430,465-475``.

``quant_dense`` makes qkv, proj, lin1 and lin2 int8 layers
(``ops/quant.QuantLinear``, kernels K8 and K9) and takes precedence over
both routes: a quant block runs neither K6 nor K7 (JAX
``image_encoder.py:362``, ``layers.py:89-90``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from protosam_tpu_torch.models.layers import (LayerNorm2d, MLPBlock,
                                              TokenLayerNorm, gelu_for)
from protosam_tpu_torch.ops.mlp import dense_residual
from protosam_tpu_torch.ops.quant import QuantLinear, dense_cls
from protosam_tpu_torch.ops.vitdet_flash import (global_packed_attention,
                                                 window_packed_attention)


def rel_pos_table(rel_pos: torch.Tensor, q_size: int,
                  k_size: int) -> torch.Tensor:
    """R[q, k, c] lookup table (reference get_rel_pos,
    image_encoder.py:303-333), linearly resized to 2·max(q, k)-1 rows when
    the stored table differs."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = F.interpolate(
            rel_pos.float().T[None], size=max_rel, mode="linear"
        )[0].T.to(rel_pos.dtype)
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.as_tensor(rel.astype(np.int64),
                                   device=rel_pos.device)]


class Attention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias; window_size 0
    means global attention over the whole (square) grid."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 input_size: tuple[int, int], quant_dense: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        hd = dim // num_heads
        self.scale = hd ** -0.5
        linear = dense_cls(quant_dense)
        self.qkv = linear(dim, 3 * dim)
        self.proj = linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, H, W, C) -> proj(attention), plus ``residual`` when given:
        under bf16 without ``quant_dense`` the projection and the add run as
        kernel K6 on the flattened (B·H·W, C) rows."""
        b, h, w, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x)                                  # (B, H, W, 3C)
        q = qkv[..., :c].reshape(b, h, w, nh, c // nh)
        win = self.window_size
        if win == 0:
            rh = rel_pos_table(self.rel_pos_h, h, h).to(q.dtype)
            rw = rel_pos_table(self.rel_pos_w, w, w).to(q.dtype)
        else:
            rh = rel_pos_table(self.rel_pos_h, win, win).to(q.dtype)
            rw = rel_pos_table(self.rel_pos_w, win, win).to(q.dtype)
            rh = rh[torch.arange(h, device=x.device) % win]
            rw = rw[torch.arange(w, device=x.device) % win]
        bias_h = torch.einsum("byxhc,ykc->byxhk", q, rh)
        bias_w = torch.einsum("byxhc,xkc->byxhk", q, rw)
        bias = torch.cat([bias_h, bias_w], dim=-1).reshape(b, h, w, -1)
        if win == 0:
            out = global_packed_attention(qkv, bias, nh, self.scale)
        else:
            ph, pw = (-h) % win, (-w) % win
            if ph or pw:
                qkv = F.pad(qkv, (0, 0, 0, pw, 0, ph))
                inside = torch.zeros(h + ph, w + pw, 1, dtype=torch.bool,
                                     device=x.device)
                inside[:h, :w] = True
                qkv = torch.where(inside, qkv,
                                  self.qkv.bias.to(qkv.dtype))
                bias = F.pad(bias, (0, 0, 0, pw, 0, ph))
            out = window_packed_attention(qkv, bias.contiguous(), win, nh,
                                          self.scale)[:, :h, :w]
        if residual is None:
            return self.proj(out)
        if out.dtype != torch.bfloat16 or isinstance(self.proj, QuantLinear):
            return residual + self.proj(out)
        return dense_residual(out.reshape(-1, c), self.proj.weight,
                              self.proj.bias, residual.reshape(-1, c)
                              ).reshape(residual.shape)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, input_size: tuple[int, int],
                 fused_mlp: bool = False, fused_proj: bool = False,
                 quant_dense: bool = False):
        super().__init__()
        self.fused_mlp = fused_mlp
        self.fused_proj = fused_proj
        self.norm1 = TokenLayerNorm(dim, 1e-6)
        self.attn = Attention(dim, num_heads, window_size,
                              input_size if window_size == 0
                              else (window_size, window_size), quant_dense)
        self.norm2 = TokenLayerNorm(dim, 1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), gelu_for, quant_dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf16 = x.dtype == torch.bfloat16
        if self.fused_proj and bf16:
            x = self.attn(self.norm1(x), residual=x)
        else:
            x = x + self.attn(self.norm1(x))
        if self.fused_mlp and bf16:
            c = x.shape[-1]
            return self.mlp(self.norm2(x).reshape(-1, c),
                            residual=x.reshape(-1, c),
                            fused=True).reshape(x.shape)
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """1024² -> (B, out_chans, 64, 64); configs per reference
    build_sam.py:55-107 (window 14, four global blocks)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (),
                 fused_mlp: bool = False, fused_proj: bool = False,
                 quant_dense: bool = False):
        super().__init__()
        grid = img_size // patch_size
        self.img_size = img_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size,
                                          patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size,
                  (grid, grid), fused_mlp, fused_proj, quant_dense)
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) preprocessed pixels -> (B, out_chans, H/16,
        W/16) in the encoder's compute dtype."""
        dt = self.patch_embed.proj.weight.dtype
        x = self.patch_embed.proj(x.to(dt)).permute(0, 2, 3, 1)
        x = x + self.pos_embed.to(dt)
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))
