"""DINOv2 packed masked attention: kernel K2 on the card, a plain version on
the CPU."""

from __future__ import annotations

import torch

from protosam_tpu_torch import kernels


def masked_attention_packed_plain(qkv: torch.Tensor, *, scale: float,
                                  num_heads: int,
                                  n_valid: int | None = None
                                  ) -> torch.Tensor:
    """K2's plain version: explicit einsum + softmax in f32, one head at a
    time so the (B, S, S) f32 matrix stays bounded.  Returns qkv's dtype."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    q5 = qkv.reshape(b, s, 3, num_heads, hd)
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    for h in range(num_heads):
        q = q5[:, :, 0, h].float()
        k = q5[:, :, 1, h].float()
        v = q5[:, :, 2, h].float()
        attn = torch.einsum("bqd,bkd->bqk", q * scale, k)
        if n_valid is not None and n_valid < s:
            attn[..., n_valid:] = float("-inf")
        attn = torch.softmax(attn, dim=-1)
        out[..., h * hd:(h + 1) * hd] = torch.einsum(
            "bqk,bkd->bqd", attn, v).to(qkv.dtype)
    return out


def masked_flash_attention_packed(qkv: torch.Tensor, *, scale: float,
                                  num_heads: int,
                                  n_valid: int | None = None
                                  ) -> torch.Tensor:
    """Packed-layout masked MHA.

    qkv: (B, S, 3*C) straight from the fused qkv projection, channel order
    (3, heads, head_dim); returns (B, S, C).  Keys at index >= n_valid are
    excluded from the softmax.  Kernel K2 (``csrc/attention.cu``) on a CUDA
    tensor, the plain version on a CPU tensor.
    """
    if qkv.device.type == "cpu":
        return masked_attention_packed_plain(qkv, scale=scale,
                                             num_heads=num_heads,
                                             n_valid=n_valid)
    b, s, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    if c3 != 3 * num_heads * hd or hd > 80 or hd % 8:
        raise ValueError(f"packed attention: head_dim {hd} must be a "
                         f"multiple of 8 and at most 80 (width {c3})")
    n_valid = s if n_valid is None else min(int(n_valid), s)
    if n_valid < 1:
        raise ValueError("packed attention: n_valid must be >= 1")
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    kernels.check_cuda("packed_masked_attention", qkv, out)
    kernels.launch("ptk_packed_masked_attention", qkv.data_ptr(),
                   out.data_ptr(), b, s, num_heads, hd, n_valid,
                   float(scale), kernels.dtype_code(qkv), kernels.stream())
    masked_flash_attention_packed.launches += 1
    return out


masked_flash_attention_packed.launches = 0
