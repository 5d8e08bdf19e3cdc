"""Shared building blocks (reference segment_anything/modeling/common.py and
the DINOv2 hub modules), with the reference state_dict key names."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from protosam_tpu_torch.ops.norm import layer_norm_tokens


class TokenLayerNorm(nn.Module):
    """LayerNorm over the last axis with flax numerics (f32 stats, fast
    variance), on kernel K1.  Keys ``weight``/``bias`` as nn.LayerNorm.
    Output is ``out_dtype`` or the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 out_dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_tokens(x, self.weight, self.bias, self.eps,
                                 self.out_dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of NCHW with biased variance, computed in f32 and
    cast back (reference common.py:29-43)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(1, keepdim=True)
        s = (xf - u).pow(2).mean(1, keepdim=True)
        y = (xf - u) * torch.rsqrt(s + self.eps)
        y = self.weight.float()[:, None, None] * y \
            + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class MLPBlock(nn.Module):
    """Linear -> act -> Linear (reference common.py:13-26)."""

    def __init__(self, embedding_dim: int, mlp_dim: int,
                 act: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    """The decoder's relu MLP head (reference mask_decoder.py:154-176)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def gelu_for(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU under bf16, exact erf GELU otherwise — the encoders'
    activation policy (its tanh error is far below bf16's rounding)."""
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return nn.functional.gelu(x, approximate=approx)


def cast_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast a module's weights to the compute dtype, keeping normalisation
    params in f32 as flax does under a bf16 build."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (TokenLayerNorm, LayerNorm2d, nn.LayerNorm)):
            m.float()
    return module
