"""Dynamic W8A8 int8 dense layers for the encoders' dense stages: the
counterpart of ``protosam_tpu/ops/quant.py``, on kernels K8
``quantize_rows`` (both operands of a layer in one launch:
``quantize_operands``) and K9 ``int8_dense`` (``csrc/int8_dense.cu``).

Symmetric dynamic quantization with no calibration state: a scale per
token of the activations and per output channel of the weight, int32
accumulation, and the rank-1 dequant in the product's epilogue::

    y = ((q(x) @ q(w)ᵀ) * sx) * sw + b

``QuantLinear`` has ``nn.Linear``'s ``weight`` (N, K) and ``bias`` (N,), so
state_dicts and the converters are unchanged (JAX ``QuantDense`` keeps
``nn.Dense``'s param tree).  Its params stay f32 under a bf16 build
(``models/layers.cast_compute``): JAX quantizes the f32 params, and
quantizing bf16-rounded weights would move the amax and flip codes.

Each kernel has a plain version beside it that computes the same bits: the
int8 product runs in float64, which is exact for int8 codes at any K below
2^53 / 127² and any order of the sums, so it needs no integer matmul (the
card has none in ``torch.matmul``).  A CPU tensor takes the plain version; a
CUDA tensor takes the kernel, with no fallback.  Inference only, as in
JAX: rounding has no useful gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from protosam_tpu_torch import kernels
from protosam_tpu_torch.models.master import Linear


def quantize_rows_plain(x2: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """K8's plain version: (R, K) rows -> int8 codes (R, K) and an f32
    scale (R,), ``scale = max(amax, 1e-12) / 127``, codes rounded half to
    even.  The divisor is a tensor: on the card PyTorch would multiply by
    the reciprocal of a Python scalar, which is not always the same f32."""
    xf = x2.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp(min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale[:, None]).to(torch.int8)
    return q, scale


def quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each row of x2 (R, K), bf16 or f32:
    kernel K8 on a CUDA tensor, the plain version on a CPU tensor."""
    if x2.device.type == "cpu":
        return quantize_rows_plain(x2)
    r, k = x2.shape
    q = torch.empty((r, k), dtype=torch.int8, device=x2.device)
    scale = torch.empty((r,), dtype=torch.float32, device=x2.device)
    dev = kernels.check_cuda("quantize_rows", x2, q, scale)
    kernels.launch("ptk_quantize_rows", x2.data_ptr(), q.data_ptr(),
                   scale.data_ptr(), r, k, kernels.dtype_code(x2),
                   device=dev)
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0


def quantize_operands(x2: torch.Tensor, w: torch.Tensor) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both operands of a layer, each row quantized as ``quantize_rows``
    does: the activation rows x2 (M, K) and the weight rows w (N, K), each
    bf16 or f32 -> (qx, sx, qw, sw).  One launch of K8 on CUDA tensors
    (counted in ``quantize_rows.launches``), the plain version of each on
    CPU tensors."""
    if x2.device.type == "cpu":
        return (*quantize_rows_plain(x2), *quantize_rows_plain(w))
    m, k = x2.shape
    n = w.shape[0]
    if w.shape != (n, k):
        raise ValueError(f"quantize_operands: x2 {tuple(x2.shape)} and w "
                         f"{tuple(w.shape)} differ in K")
    qx = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    qw = torch.empty((n, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    sw = torch.empty((n,), dtype=torch.float32, device=x2.device)
    dev = kernels.check_cuda("quantize_operands", x2, w, qx, sx, qw, sw)
    kernels.launch("ptk_quantize_operands", x2.data_ptr(), qx.data_ptr(),
                   sx.data_ptr(), m, kernels.dtype_code(x2), w.data_ptr(),
                   qw.data_ptr(), sw.data_ptr(), n, kernels.dtype_code(w), k,
                   device=dev)
    quantize_rows.launches += 1
    return qx, sx, qw, sw


def int8_product_plain(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 qa (M, K) and qb (N, K)ᵀ, summed in
    float64 (exact for K < 2^53 / 127²; the card has no integer matmul in
    ``torch.matmul``)."""
    return (qa.double() @ qb.double().T).to(torch.int32)


def int8_matmul_dequant_plain(qa: torch.Tensor, qb: torch.Tensor,
                              sx: torch.Tensor, sw: torch.Tensor,
                              bias: torch.Tensor | None,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """K9's plain version: the exact int32 product, then ``((acc * sx) *
    sw) + bias`` in f32, one operation at a time, and one cast."""
    y = (int8_product_plain(qa, qb).float() * sx[:, None]) * sw[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul_dequant(qa: torch.Tensor, qb: torch.Tensor,
                        sx: torch.Tensor, sw: torch.Tensor,
                        bias: torch.Tensor | None,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """``((qa qbᵀ) * sx[:, None]) * sw + bias`` for int8 qa (M, K), qb
    (N, K), f32 sx (M,), sw (N,), bias (N,) or None: kernel K9 on CUDA
    tensors (bf16 or f32 out), the plain version on CPU tensors.  K must be
    a multiple of 16."""
    if qa.device.type == "cpu":
        return int8_matmul_dequant_plain(qa, qb, sx, sw, bias, out_dtype)
    m, k = qa.shape
    n = qb.shape[0]
    if (qb.shape != (n, k) or sx.shape != (m,) or sw.shape != (n,)
            or (bias is not None and bias.shape != (n,))):
        raise ValueError(f"int8_dense: shapes qa {tuple(qa.shape)}, qb "
                         f"{tuple(qb.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)} do not fit")
    if k % 16:
        raise ValueError(f"int8_dense: K = {k} is not a multiple of 16")
    if (qa.dtype != torch.int8 or qb.dtype != torch.int8
            or any(t.dtype != torch.float32 for t in (sx, sw, bias)
                   if t is not None)):
        raise TypeError("int8_dense: the codes must be int8, the scales "
                        "and the bias float32")
    out = torch.empty((m, n), dtype=out_dtype, device=qa.device)
    tensors = (qa, qb, sx, sw, out) + (() if bias is None else (bias,))
    dev = kernels.check_cuda("int8_dense", *tensors)
    kernels.launch("ptk_int8_dense", qa.data_ptr(), qb.data_ptr(),
                   sx.data_ptr(), sw.data_ptr(),
                   None if bias is None else bias.data_ptr(),
                   out.data_ptr(), m, n, k, kernels.dtype_code(out),
                   device=dev)
    int8_matmul_dequant.launches += 1
    return out


int8_matmul_dequant.launches = 0


def quantize_symmetric(x: torch.Tensor) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Symmetric int8 quantization over the last axis: (q, scale) with q
    int8 in [-127, 127] shaped like x and scale f32 shaped like x with the
    last axis kept as 1, so x ≈ q * scale (JAX ``quantize_symmetric`` with
    ``axis=-1``)."""
    k = x.shape[-1]
    q, scale = quantize_rows(x.reshape(-1, k).contiguous())
    return q.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ weightᵀ + bias`` through the int8 path: x (..., K), weight
    (N, K) in ``nn.Linear``'s layout, bias (N,) or None.  One K8 launch
    (activations and weight) and one K9 on the card; the weight's codes
    are recomputed on every call, as JAX does."""
    k = x.shape[-1]
    qx, sx, qw, sw = quantize_operands(x.reshape(-1, k).contiguous(),
                                       weight.contiguous())
    y = int8_matmul_dequant(qx, qw, sx, sw, bias, out_dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


class QuantLinear(nn.Linear):
    """``nn.Linear`` with the int8 forward (JAX ``QuantDense``): the same
    ``weight`` / ``bias`` keys and shapes, kept in f32; the output takes the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight, self.bias, x.dtype)


def dense_cls(quant: bool) -> type[nn.Linear]:
    """The encoder blocks' dense layer: ``Linear``, or ``QuantLinear``
    when the int8 path is on."""
    return QuantLinear if quant else Linear
