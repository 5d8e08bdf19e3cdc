"""The SAM encoder's fused projection and MLP: kernels K6 ``dense_residual``
(``csrc/mlp.cu``) and K7 ``mlp_fused`` (``csrc/mlp_fused.cu``), the
counterparts of ``protosam_tpu/ops/mlp_pallas.py``.

Weights come in the ``nn.Linear`` layout ``(out, in)`` as the modules store
them, so no call transposes or casts a weight.  The plain versions compute
the TPU kernels' numerics, not the unfused composition: f32-accumulated
products, bias and residual added in f32, the tanh GELU in f32 with the
hidden activation cast to the input type before the second product, and
one rounding at the end (``mlp_pallas.py:46-67,80-84``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from protosam_tpu_torch import kernels


def dense_residual_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         residual: torch.Tensor) -> torch.Tensor:
    """K6's plain version: ``x wᵀ + b + residual`` in f32, one rounding."""
    y = x.float() @ w.float().T + b.float()
    return (y + residual.float()).to(x.dtype)


def mlp_fused_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """K7's plain version: ``gelu_tanh(x w1ᵀ + b1) w2ᵀ + b2 (+ residual)``
    with the TPU kernel's roundings."""
    h = x.float() @ w1.float().T + b1.float()
    g = F.gelu(h, approximate="tanh").to(x.dtype)
    y = b2.float()
    if residual is not None:
        y = y + residual.float()
    return (y + g.float() @ w2.float().T).to(x.dtype)


def _check_bf16(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")


def dense_residual(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   residual: torch.Tensor) -> torch.Tensor:
    """``x wᵀ + b + residual`` for x (M, K), w (N, K), b (N,), residual
    (M, N): kernel K6 on CUDA bf16 tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return dense_residual_plain(x, w, b, residual)
    m, k = x.shape
    n = w.shape[0]
    if w.shape != (n, k) or b.shape != (n,) or residual.shape != (m, n):
        raise ValueError(f"dense_residual: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, residual "
                         f"{tuple(residual.shape)} do not fit")
    if k % 8:
        raise ValueError(f"dense_residual: K = {k} is not a multiple of 8")
    _check_bf16("dense_residual", x, w, b, residual)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    dev = kernels.check_cuda("dense_residual", x, w, b, residual, out)
    kernels.launch("ptk_dense_residual", x.data_ptr(), w.data_ptr(),
                   b.data_ptr(), residual.data_ptr(), out.data_ptr(), m, k,
                   n, device=dev)
    dense_residual.launches += 1
    return out


dense_residual.launches = 0


def mlp_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """``gelu_tanh(x w1ᵀ + b1) w2ᵀ + b2 (+ residual)`` for x (M, C), w1
    (H, C), w2 (C, H): kernel K7 on CUDA bf16 tensors, the plain version on
    CPU tensors.  K7 runs in clusters of eight blocks that share each hidden
    chunk through distributed shared memory, so the (M, H) hidden
    activation never reaches device memory and nothing is allocated for it;
    x, w1 and w2 are read by TMA, which needs them contiguous and 16-byte
    aligned.  A launch the card cannot take raises."""
    if x.device.type == "cpu":
        return mlp_fused_plain(x, w1, b1, w2, b2, residual)
    m, c = x.shape
    h = w1.shape[0]
    if (w1.shape != (h, c) or b1.shape != (h,) or w2.shape != (c, h)
            or b2.shape != (c,)
            or (residual is not None and residual.shape != (m, c))):
        raise ValueError(f"mlp_fused: shapes x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not fit")
    if c % 16 or h % 16 or c > 1280:
        raise ValueError(f"mlp_fused: C = {c} and H = {h} must be multiples "
                         "of 16, C at most 1280")
    extra = () if residual is None else (residual,)
    _check_bf16("mlp_fused", x, w1, b1, w2, b2, *extra)
    out = torch.empty_like(x)
    dev = kernels.check_cuda("mlp_fused", x, w1, b1, w2, b2, out, *extra)
    kernels.launch("ptk_mlp_fused", x.data_ptr(), w1.data_ptr(),
                   b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                   None if residual is None else residual.data_ptr(),
                   out.data_ptr(), m, c, h, device=dev)
    mlp_fused.launches += 1
    return out


mlp_fused.launches = 0
