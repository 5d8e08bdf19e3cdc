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
    excluded from the softmax.  Kernel K2 on a CUDA tensor (bf16:
    ``csrc/packed_attention.cu``, on ``wgmma``; f32: the CUDA-core
    instantiation in ``csrc/attention.cu``), the plain version on a CPU
    tensor.  ``score_dtype=torch.bfloat16`` (bf16 inputs only) rounds the
    scores as microbench_attn's v3 does, on ``csrc/attention.cu``'s
    bf16-score instantiation; its launches are counted in
    ``bf16_score_launches``, apart from K2's ``launches``.

    Under grad the forward is the same and the backward is the VJP of the
    per-head plain math (``packed_attention_head_math``, JAX
    ``_packed_attn_bwd``), counted in ``backward_calls``.  The bf16-score
    instantiation is a measurement variant and refuses to run under grad.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        if score_dtype != torch.float32:
            raise RuntimeError("packed attention: the bf16-score variant "
                               "has no backward; it is a measurement tool")
        return _PackedAttention.apply(qkv, float(scale), num_heads, n_valid)
    return _packed_attention_launch(qkv, scale, num_heads, n_valid,
                                    score_dtype)


def _packed_attention_launch(qkv, scale, num_heads, n_valid, score_dtype):
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
    dev = kernels.check_cuda("packed_masked_attention", qkv, out)
    kernels.launch("ptk_packed_masked_attention", qkv.data_ptr(),
                   out.data_ptr(), b, s, num_heads, hd, n_valid,
                   float(scale), kernels.dtype_code(qkv), int(bf16_scores),
                   device=dev)
    if bf16_scores:
        masked_flash_attention_packed.bf16_score_launches += 1
    else:
        masked_flash_attention_packed.launches += 1
    return out


def packed_attention_head_math(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float,
                               n_valid: int | None) -> torch.Tensor:
    """One head of JAX's ``_packed_math`` (``ops/attention.py:313-340``),
    the function K2's backward differentiates: q (B, S, hd) scaled in its
    own dtype, scores in f32, keys >= n_valid at -inf, softmax in f32, P
    cast to V's dtype, P·V summed in f32 and cast."""
    attn = torch.einsum("bqd,bkd->bqk", (q * scale).float(), k.float())
    if n_valid is not None and n_valid < attn.shape[-1]:
        keep = torch.arange(attn.shape[-1], device=attn.device) < n_valid
        attn = torch.where(keep, attn, float("-inf"))
    p = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p.float(), v.float()).to(v.dtype)


def packed_attention_head_vjp(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor, scale: float,
                              n_valid: int | None
                              ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``packed_attention_head_math`` at cotangent g, op by
    op as autograd takes that function back (the scores recomputed, the
    output not): f32 products, P's round trip through V's dtype on both
    passes, the softmax VJP ``p·(dp - Σ dp·p)`` (0 on the masked keys),
    and each gradient cast to its input's dtype, q's then scaled in it."""
    qf, kf, vf = (q * scale).float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(1, 2))
    if n_valid is not None and n_valid < s.shape[-1]:
        s[..., n_valid:] = float("-inf")
    p = torch.softmax(s, dim=-1)
    del s
    gf = g.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(1, 2), gf).to(v.dtype)
    dp = torch.matmul(gf, vf.transpose(1, 2)).to(v.dtype).float()
    dp -= (dp * p).sum(dim=-1, keepdim=True)
    dp *= p                                   # dS
    dq = torch.matmul(dp, kf).to(q.dtype) * scale
    dk = torch.matmul(dp.transpose(1, 2), qf).to(k.dtype)
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """K2 forward; the backward recomputes one head at a time, so only one
    head's (B, S, S) scores live at once."""

    @staticmethod
    def forward(ctx, qkv, scale, num_heads, n_valid):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.num_heads, ctx.n_valid = scale, num_heads, n_valid
        return _packed_attention_launch(qkv, scale, num_heads, n_valid,
                                        torch.float32)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        c = qkv.shape[-1] // 3
        hd = c // ctx.num_heads
        grad = torch.empty_like(qkv)
        for h in range(ctx.num_heads):
            cols = [slice(part * c + h * hd, part * c + (h + 1) * hd)
                    for part in range(3)]
            heads = packed_attention_head_vjp(
                *(qkv[..., sl] for sl in cols), g[..., h * hd:(h + 1) * hd],
                ctx.scale, ctx.n_valid)
            for sl, gh in zip(cols, heads):
                grad[..., sl] = gh
        masked_flash_attention_packed.backward_calls += 1
        return grad, None, None, None


masked_flash_attention_packed.launches = 0
masked_flash_attention_packed.bf16_score_launches = 0
masked_flash_attention_packed.backward_calls = 0
