"""DINOv2 packed masked attention: kernel K2 on the card, a plain version on
the CPU.

``score_dtype=torch.bfloat16`` takes K2's bf16-score instantiation, the
counterpart of variant v3 of ``tools/microbench_attn.py`` (``_v2_kernel``
with bf16 scores): a different function from K2, taken only by the
measurement tools.
"""

from __future__ import annotations

import torch

from protosam_tpu_torch import kernels


def masked_attention_packed_plain(qkv: torch.Tensor, *, scale: float,
                                  num_heads: int,
                                  n_valid: int | None = None,
                                  score_dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """K2's plain version: explicit einsum + softmax in f32, one head at a
    time so the (B, S, S) f32 matrix stays bounded.  Returns qkv's dtype.

    ``score_dtype=torch.bfloat16`` (bf16 inputs only) reproduces the
    roundings of microbench_attn's v3 in one pass: q pre-scaled and rounded
    to bf16, scores accumulated in f32 and rounded to bf16, the row max over
    bf16 values, ``p = exp(s - m)`` on the bf16 difference rounded to bf16,
    PV in f32 divided by the f32 sum of the bf16 ``p``
    (``microbench_attn.py:104-134``)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    bf16_scores = _bf16_scores(qkv, score_dtype)
    q5 = qkv.reshape(b, s, 3, num_heads, hd)
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    for h in range(num_heads):
        q = q5[:, :, 0, h].float()
        k = q5[:, :, 1, h].float()
        v = q5[:, :, 2, h].float()
        if bf16_scores:
            q = (q * scale).to(torch.bfloat16).float()
            attn = torch.einsum("bqd,bkd->bqk", q, k)
        else:
            attn = torch.einsum("bqd,bkd->bqk", q * scale, k)
        if n_valid is not None and n_valid < s:
            attn[..., n_valid:] = float("-inf")
        if bf16_scores:
            sb = attn.to(torch.bfloat16)
            p = torch.exp(sb - sb.amax(dim=-1, keepdim=True)).float()
            o = torch.einsum("bqk,bkd->bqd", p, v) / p.sum(dim=-1,
                                                          keepdim=True)
        else:
            o = torch.einsum("bqk,bkd->bqd", torch.softmax(attn, dim=-1), v)
        out[..., h * hd:(h + 1) * hd] = o.to(qkv.dtype)
    return out


def _bf16_scores(qkv: torch.Tensor, score_dtype: torch.dtype) -> bool:
    if score_dtype == torch.float32:
        return False
    if score_dtype != torch.bfloat16 or qkv.dtype != torch.bfloat16:
        raise TypeError(f"packed attention: score_dtype {score_dtype} with "
                        f"{qkv.dtype} inputs; bf16 scores need bf16 inputs")
    return True


def masked_flash_attention_packed(qkv: torch.Tensor, *, scale: float,
                                  num_heads: int,
                                  n_valid: int | None = None,
                                  score_dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """Packed-layout masked MHA.

    qkv: (B, S, 3*C) straight from the fused qkv projection, channel order
    (3, heads, head_dim); returns (B, S, C).  Keys at index >= n_valid are
    excluded from the softmax.  Kernel K2 (``csrc/attention.cu``) on a CUDA
    tensor, the plain version on a CPU tensor.  ``score_dtype=
    torch.bfloat16`` (bf16 inputs only) rounds the scores as
    microbench_attn's v3 does; its launches are counted in
    ``bf16_score_launches``, apart from K2's ``launches``.
    """
    bf16_scores = _bf16_scores(qkv, score_dtype)
    if qkv.device.type == "cpu":
        return masked_attention_packed_plain(qkv, scale=scale,
                                             num_heads=num_heads,
                                             n_valid=n_valid,
                                             score_dtype=score_dtype)
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
                   float(scale), kernels.dtype_code(qkv), int(bf16_scores),
                   kernels.stream())
    if bf16_scores:
        masked_flash_attention_packed.bf16_score_launches += 1
    else:
        masked_flash_attention_packed.launches += 1
    return out


masked_flash_attention_packed.launches = 0
masked_flash_attention_packed.bf16_score_launches = 0
