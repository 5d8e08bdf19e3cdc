"""Normalization helpers matching the reference ALP numerics, and the token
LayerNorm that runs on kernel K1."""

from __future__ import annotations

import torch

from protosam_tpu_torch import kernels


def clamped_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-4,
                 keepdim: bool = False) -> torch.Tensor:
    """max(||x||_2, eps), computed as sqrt(max(sum x², eps²))."""
    n2 = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(n2, min=eps * eps))


def safe_l2_normalize(x: torch.Tensor, dim: int = -1,
                      eps: float = 1e-4) -> torch.Tensor:
    """``x / max(||x||_2, eps)`` (reference models/alpmodule.py:14-18)."""
    return x / clamped_norm(x, dim=dim, eps=eps, keepdim=True)


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, dim: int = -1,
                      eps: float = 1e-4) -> torch.Tensor:
    """``x·y / (max(||x||,eps)·max(||y||,eps))`` (F.cosine_similarity)."""
    dot = torch.sum(x * y, dim=dim)
    return dot / (clamped_norm(x, dim=dim, eps=eps)
                  * clamped_norm(y, dim=dim, eps=eps))


def layer_norm_rows_plain(x2: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """K1's plain version: flax nn.LayerNorm numerics in f32 (fast
    variance clipped at 0), one cast at the end."""
    xf = x2.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - m * m, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((xf - m) * mul + bias.float()).to(out_dtype)


def _layer_norm_launch(x2: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float,
                       out_dtype: torch.dtype) -> torch.Tensor:
    if x2.device.type == "cpu":
        return layer_norm_rows_plain(x2, weight, bias, eps, out_dtype)
    n, c = x2.shape
    w32 = weight.float().contiguous()
    b32 = bias.float().contiguous()
    if w32.shape != (c,) or b32.shape != (c,):
        raise ValueError(f"layer_norm_rows: weight/bias must be ({c},)")
    out = torch.empty((n, c), dtype=out_dtype, device=x2.device)
    dev = kernels.check_cuda("layer_norm_rows", x2, w32, b32, out)
    kernels.launch("ptk_layer_norm_rows", x2.data_ptr(), w32.data_ptr(),
                   b32.data_ptr(), out.data_ptr(), n, c, float(eps),
                   kernels.dtype_code(x2), kernels.dtype_code(out),
                   device=dev)
    layer_norm_rows.launches += 1
    return out


class _LayerNormRows(torch.autograd.Function):
    """K1 forward; the backward is the VJP of the plain math, recomputed
    (JAX ``_ln_tpu_bwd``, ``ops/norm.py:127-134``)."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps, out_dtype):
        ctx.save_for_backward(x2, weight, bias)
        ctx.eps, ctx.out_dtype = eps, out_dtype
        return _layer_norm_launch(x2, weight, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x2, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x2, weight, bias)]
            y = layer_norm_rows_plain(*ins, ctx.eps, ctx.out_dtype)
            grads = torch.autograd.grad(y, ins, g)
        layer_norm_rows.backward_calls += 1
        return (*grads, None, None)


@torch.library.custom_op("ptk::layer_norm_rows", mutates_args=())
def _layer_norm_op(x2: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """K1 as one opaque operator, for programs that ``torch.export``
    traces (``utils/export.py``): the program records this op, and running
    it launches K1 on a CUDA tensor (the plain version on a CPU one)."""
    return _layer_norm_launch(x2, weight, bias, eps, out_dtype)


@_layer_norm_op.register_fake
def _(x2, weight, bias, eps, out_dtype):
    return x2.new_empty(x2.shape, dtype=out_dtype)


def layer_norm_rows(x2: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-6,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """LayerNorm over the last axis of (N, C) rows: kernel K1
    (``csrc/layer_norm.cu``) on a CUDA tensor, the plain version on a CPU
    tensor.  Under grad the forward is the same and the backward is the
    plain version's VJP (counted in ``backward_calls``): gradients reach
    ``x2`` in its dtype and the f32 ``weight`` / ``bias``.  While
    ``torch.export`` traces, the call is the opaque ``ptk::layer_norm_rows``
    op, which launches K1 when the exported program runs."""
    out_dtype = out_dtype or x2.dtype
    if torch.compiler.is_exporting():
        return _layer_norm_op(x2, weight, bias, eps, out_dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2, weight, bias)):
        return _LayerNormRows.apply(x2, weight, bias, eps, out_dtype)
    return _layer_norm_launch(x2, weight, bias, eps, out_dtype)


layer_norm_rows.launches = 0
layer_norm_rows.backward_calls = 0


def layer_norm_tokens(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-6,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """LayerNorm over the last axis of (..., C) with flax numerics."""
    c = x.shape[-1]
    y = layer_norm_rows(x.reshape(-1, c).contiguous(), weight, bias, eps,
                        out_dtype)
    return y.reshape(x.shape)
