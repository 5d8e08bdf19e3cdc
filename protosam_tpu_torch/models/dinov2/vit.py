"""DINOv2 vision transformer (frozen feature extractor), hub state_dict
layout: ViT with 14-px patches, cls token (+ optional registers),
LayerScale, pre-norm blocks and bicubic pos-embed interpolation.  The FFN
is the variant's: fc1-GELU-fc2 (``Mlp``), or for ViT-g/14 the gated
``SwiGLUFFN`` (hub ``layers/swiglu_ffn.py``, ``ffn_layer="swiglufused"``).

The reference consumes ``forward_features(...)["x_norm_patchtokens"]``
(grid_proto_fewshot.py:90-98).  Attention runs on kernel K2 straight from
the packed qkv projection; the block LayerNorms run on kernel K1.
``quant_dense`` makes the blocks' qkv, proj and FFN layers int8 layers
(``ops/quant.QuantLinear``, kernels K8 and K9), JAX ``vit.py:50-64,111-130``.

The position encoding resized to a grid depends only on ``pos_embed``, the
grid and the compute dtype, so each encoder keeps it per grid, dtype and
device, tied to the weight it came from (``_pos_encoding``).

Traced (``utils/profiling.py``): ``dinov2.encode`` around a forward pass,
counting its ``images``, ``tokens`` (the padded sequence times the images),
``blocks`` and ``pos_builds`` (1 where the call resized the position
encoding, 0 where the encoder's cache served it), and ``dinov2.ffn`` around
each block's FFN.
"""

from __future__ import annotations

import collections
import threading
from typing import Any

import torch
from torch import nn

from protosam_tpu_torch.models.layers import (TokenLayerNorm, cast_compute,
                                              gelu_for)
from protosam_tpu_torch.models.master import Conv2d
from protosam_tpu_torch.ops.attention import masked_flash_attention_packed
from protosam_tpu_torch.ops.quant import dense_cls
from protosam_tpu_torch.ops.resize import resize_bicubic_torch
from protosam_tpu_torch.utils import profiling

# resized position encodings kept per encoder: one a grid, dtype and device
# (a few MB each at published widths); tools that sweep input sizes cannot
# grow it without limit
POS_CACHE_SIZE = 8
_pos_lock = threading.Lock()  # serve.py answers each request on a thread


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, quant_dense: bool = False):
        super().__init__()
        linear = dense_cls(quant_dense)
        self.num_heads = num_heads
        self.qkv = linear(dim, 3 * dim)
        self.proj = linear(dim, dim)

    def forward(self, x: torch.Tensor,
                valid_tokens: int | None) -> torch.Tensor:
        qkv = self.qkv(x)
        # the head width from qkv: a tensor-parallel shard holds fewer heads
        hd = qkv.shape[-1] // (3 * self.num_heads)
        out = masked_flash_attention_packed(
            qkv, scale=hd ** -0.5, num_heads=self.num_heads,
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

    @staticmethod
    def hidden_features(dim: int, mlp_ratio: float) -> int:
        return int(dim * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_for(self.fc1(x)))


class SwiGLUFFN(nn.Module):
    """The gated FFN of ViT-g/14: ``w3(silu(x1) * x2)`` with ``x1, x2 =
    w12(x).chunk(2, -1)`` (hub ``SwiGLUFFN`` / ``SwiGLUFFNFused``, the same
    keys)."""

    def __init__(self, dim: int, hidden: int, quant_dense: bool = False):
        super().__init__()
        linear = dense_cls(quant_dense)
        self.w12 = linear(dim, 2 * hidden)
        self.w3 = linear(hidden, dim)

    @staticmethod
    def hidden_features(dim: int, mlp_ratio: float) -> int:
        """The hub's ``SwiGLUFFNFused`` width: two thirds of ``dim *
        mlp_ratio``, rounded up to a multiple of 8 (4096 at ViT-g's
        1536)."""
        return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(nn.functional.silu(x1) * x2)


FFNS: dict[str, type[nn.Module]] = {"mlp": Mlp, "swiglu": SwiGLUFFN}


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 quant_dense: bool = False, ffn: type[nn.Module] = Mlp):
        super().__init__()
        self.norm1 = TokenLayerNorm(dim, 1e-6)
        self.attn = Attention(dim, num_heads, quant_dense)
        self.ls1 = LayerScale(dim)
        self.norm2 = TokenLayerNorm(dim, 1e-6)
        self.mlp = ffn(dim, ffn.hidden_features(dim, mlp_ratio), quant_dense)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor,
                valid_tokens: int | None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), valid_tokens))
        y = self.norm2(x)
        with profiling.span("dinov2.ffn", device=x.device):
            y = self.mlp(y)
        return x + self.ls2(y)


class DinoVisionTransformer(nn.Module):
    # set with f32 master weights (``cast_compute(..., master_weights=True)``)
    compute_dtype: torch.dtype | None = None
    # left f32 by ``cast_compute``: JAX resizes the f32 param (vit.py:
    # 176-183, 245-247) and casts the result
    f32_params = ("pos_embed",)
    # forwards that resized the position encoding, over every encoder (the
    # others were served from their encoder's cache)
    pos_builds = 0

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 pos_embed_size: int = 37,
                 interpolate_antialias: bool = False,
                 interpolate_offset: float = 0.1, quant_dense: bool = False,
                 ffn: str = "mlp"):
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
        self.patch_embed.proj = Conv2d(3, embed_dim, patch_size,
                                       patch_size)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, quant_dense, FFNS[ffn])
            for _ in range(depth))
        # f32 even under a bf16 build: it feeds the ALP cosine match whose
        # argmax seeds CCA and every SAM prompt (the f32 coarse tail)
        self.norm = TokenLayerNorm(embed_dim, 1e-6, out_dtype=torch.float32)
        # a plain attribute, not a buffer: no state_dict or cast sees it
        self._pos_cache: collections.OrderedDict = collections.OrderedDict()

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, 3, H, W), H/W divisible by the patch size.  Returns
        ``x_norm_clstoken`` (B, C), ``x_norm_regtokens``,
        ``x_norm_patchtokens`` (B, N, C), all f32."""
        b, _, h, w = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        with profiling.span("dinov2.encode", device=x.device, images=b,
                            blocks=len(self.blocks)) as enc:
            dt = self.compute_dtype or self.patch_embed.proj.weight.dtype
            x = self.patch_embed.proj(x.to(dt)).flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
            pos, enc.attrs["pos_builds"] = self._pos_encoding(gh, gw, dt)
            x = x + pos
            if self.num_register_tokens:
                x = torch.cat([x[:, :1],
                               self.register_tokens.to(dt).expand(b, -1, -1),
                               x[:, 1:]], dim=1)
            # pad the sequence once to a 128 multiple and mask the pad keys
            # in every layer (small test-size sequences are not padded)
            n_tokens = x.shape[1]
            n_pad = (-n_tokens) % 128 if n_tokens >= 2048 else 0
            if n_pad:
                x = nn.functional.pad(x, (0, 0, 0, n_pad))
            enc.attrs["tokens"] = b * x.shape[1]
            valid = n_tokens if n_pad else None
            for blk in self.blocks:
                x = blk(x, valid)
            x = self.norm(x[:, :n_tokens])
        r = self.num_register_tokens
        return {"x_norm_clstoken": x[:, 0],
                "x_norm_regtokens": x[:, 1:1 + r],
                "x_norm_patchtokens": x[:, 1 + r:]}

    def _pos_encoding(self, gh: int, gw: int,
                      dt: torch.dtype) -> tuple[torch.Tensor, int]:
        """``_interpolate_pos_encoding(gh, gw).to(dt)``, and 1 where this
        call computed it, 0 where the cache served it.  An entry holds the
        weight it was built from: a new ``pos_embed`` (a load, a cast, a
        move, a copy) moves its id or pointer and an in-place step its
        ``_version``, and either builds the entry anew; the source's
        storage stays alive with the entry, so its address cannot come back
        as another weight's.  Computed on every call where autograd tracks
        ``pos_embed`` (training), and for an inference tensor, whose
        in-place writes move no ``_version``."""
        pe = self.pos_embed
        if (torch.is_grad_enabled() and pe.requires_grad) or \
                pe.is_inference():
            with _pos_lock:
                DinoVisionTransformer.pos_builds += 1
            return self._interpolate_pos_encoding(gh, gw).to(dt), 1
        slot = (gh, gw, dt, pe.device)
        weight = (id(pe), pe.data_ptr(), pe._version, pe.dtype, pe.shape)
        with _pos_lock:
            hit = self._pos_cache.get(slot)
            if hit is not None and hit[0] == weight:
                self._pos_cache.move_to_end(slot)
                return hit[2], 0
        # a plain tensor even when first built under inference_mode, so that
        # a later grad-enabled call on a frozen encoder may use it
        with torch.inference_mode(False), torch.no_grad():
            pos = self._interpolate_pos_encoding(gh, gw).to(dt)
        with _pos_lock:
            DinoVisionTransformer.pos_builds += 1
            self._pos_cache[slot] = (weight, pe.detach(), pos)
            self._pos_cache.move_to_end(slot)
            while len(self._pos_cache) > POS_CACHE_SIZE:
                self._pos_cache.popitem(last=False)
        return pos, 1

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
    "dinov2_vitg14": dict(embed_dim=1536, depth=40, num_heads=24,
                          ffn="swiglu"),
    # test-size models for CPU-runnable configs
    "dinov2_vitt14": dict(embed_dim=64, depth=2, num_heads=2),
    "dinov2_vitgt14": dict(embed_dim=96, depth=2, num_heads=4, ffn="swiglu"),
}


def build_dinov2(name: str,
                 quant_dense: bool = False) -> DinoVisionTransformer:
    if name not in _DINO_CONFIGS:
        raise KeyError(f"unknown DINOv2 variant {name!r}; "
                       f"have {sorted(_DINO_CONFIGS)}")
    return DinoVisionTransformer(quant_dense=quant_dense,
                                 **_DINO_CONFIGS[name])


__all__ = ["DinoVisionTransformer", "SwiGLUFFN", "build_dinov2",
           "cast_compute"]
