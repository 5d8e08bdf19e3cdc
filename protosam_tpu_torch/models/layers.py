"""Shared building blocks (reference segment_anything/modeling/common.py and
the DINOv2 hub modules), with the reference state_dict key names."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from protosam_tpu_torch.models.backbones.resnet import FrozenBatchNorm
from protosam_tpu_torch.ops.mlp import mlp_fused
from protosam_tpu_torch.ops.norm import layer_norm_tokens
from protosam_tpu_torch.ops.quant import QuantLinear, dense_cls


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
    """Linear -> act -> Linear (reference common.py:13-26), with an optional
    residual added to the output.

    ``fused=True`` routes a 2-D bf16 input through kernel K7 ``mlp_fused``
    (both products, the tanh GELU and the residual in one kernel; JAX
    ``layers.py:80-117``).  The kernel hard-codes the tanh GELU, which is
    ``act`` under bf16 for the SAM encoder, its only caller.  The
    parameters stay ``lin1`` / ``lin2`` either way.  ``quant_dense`` makes
    both int8 layers (``ops/quant.QuantLinear``) and takes precedence over
    ``fused``: a quant block never runs K7 (JAX ``layers.py:89-90``).
    """

    def __init__(self, embedding_dim: int, mlp_dim: int,
                 act: Callable[[torch.Tensor], torch.Tensor],
                 quant_dense: bool = False):
        super().__init__()
        linear = dense_cls(quant_dense)
        self.lin1 = linear(embedding_dim, mlp_dim)
        self.lin2 = linear(mlp_dim, embedding_dim)
        self.act = act

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                fused: bool = False) -> torch.Tensor:
        if (fused and not isinstance(self.lin1, QuantLinear)
                and x.dtype == torch.bfloat16 and x.ndim == 2):
            return mlp_fused(x, self.lin1.weight, self.lin1.bias,
                             self.lin2.weight, self.lin2.bias, residual)
        y = self.lin2(self.act(self.lin1(x)))
        return y if residual is None else residual + y


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


def cast_compute(module: nn.Module, dtype: torch.dtype,
                 master_weights: bool = False) -> nn.Module:
    """Cast a module's params to the compute dtype (the encoders hold no
    buffers).  Normalisation params (frozen BatchNorm's too) and
    ``QuantLinear`` params are not cast at all: flax keeps the norms'
    params f32 under a bf16 build and uses them unrounded, and the int8
    path quantizes the f32 params, as JAX ``QuantDense`` does; a round
    trip through bf16 would move them.  Nor are the params a module names
    in ``f32_params`` (DINOv2's ``pos_embed``, which JAX resizes in f32
    from the f32 param before the cast).

    ``master_weights=True`` (the training build) casts nothing: every
    module with a ``compute_dtype`` (``models/master.Linear`` / ``Conv2d``,
    the DINOv2 and ResNet encoders) computes in ``dtype`` from its f32
    params, as flax does, so an optimizer steps f32 weights."""
    for m in module.modules():
        if master_weights:
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        elif not isinstance(m, (QuantLinear, TokenLayerNorm, LayerNorm2d,
                                nn.LayerNorm, FrozenBatchNorm)):
            keep = getattr(m, "f32_params", ())
            for name, p in m.named_parameters(recurse=False):
                if name not in keep:
                    p.data = p.data.to(dtype)
    return module
