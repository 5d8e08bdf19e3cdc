"""ViTDet attention with the decomposed relative-position bias over packed
operands (SAM image encoder): kernel K4 on the card, a plain version on the
CPU.

Windowed and global layers compute the same thing over a square patch of
tokens: ``softmax(scale·q·k + bias_h[q, row(k)] + bias_w[q, col(k)])·v``,
with the patch a 14×14 window of the window-padded grid or the whole grid.
The compact bias factors arrive precomputed per query as
``(B, Hp, Wp, nh·2·P)``, laid out ``[bias_h(P) | bias_w(P)]`` per head.
"""

from __future__ import annotations

import torch

from protosam_tpu_torch import kernels


def _to_patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, Hp, Wp, D) -> (B·nwy·nwx, p², D)."""
    b, hp, wp, d = x.shape
    x = x.reshape(b, hp // p, p, wp // p, p, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, p * p, d)


def _from_patches(x: torch.Tensor, b: int, hp: int, wp: int,
                  p: int) -> torch.Tensor:
    d = x.shape[-1]
    x = x.reshape(b, hp // p, wp // p, p, p, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, d)


def relpos_patch_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                 patch: int, num_heads: int,
                                 scale: float) -> torch.Tensor:
    """K4's plain version: per head, explicit f32 scores plus the expanded
    bias, softmax and PV over every patch.  Returns qkv's dtype."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    p = patch
    tok = _to_patches(qkv, p)                     # (N, p², 3C)
    bb = _to_patches(bias, p)                     # (N, p², nh·2p)
    keys = torch.arange(p * p, device=qkv.device)
    krow, kcol = keys // p, keys % p
    out = torch.empty(tok.shape[:2] + (c,), dtype=qkv.dtype,
                      device=qkv.device)
    for h in range(num_heads):
        q = tok[..., h * hd:(h + 1) * hd].float()
        k = tok[..., c + h * hd:c + (h + 1) * hd].float()
        v = tok[..., 2 * c + h * hd:2 * c + (h + 1) * hd].float()
        bh = bb[..., h * 2 * p:h * 2 * p + p].float()
        bw = bb[..., h * 2 * p + p:(h + 1) * 2 * p].float()
        attn = (torch.einsum("nqd,nkd->nqk", q * scale, k)
                + bh[..., krow] + bw[..., kcol])
        attn = torch.softmax(attn, dim=-1)
        out[..., h * hd:(h + 1) * hd] = torch.einsum(
            "nqk,nkd->nqd", attn, v).to(qkv.dtype)
    return _from_patches(out, b, hp, wp, p)


def relpos_patch_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           patch: int, num_heads: int,
                           scale: float) -> torch.Tensor:
    """Rel-pos attention inside every ``patch``×``patch`` patch of qkv
    (B, Hp, Wp, 3C) with compact bias (B, Hp, Wp, nh·2·patch); returns
    (B, Hp, Wp, C).  Kernel K4 on a CUDA tensor (bf16:
    ``csrc/relpos_attention.cu``; f32: ``csrc/attention.cu``), the plain
    version on a CPU tensor."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    if hp % patch or wp % patch:
        raise ValueError(f"grid {hp}x{wp} is not a multiple of {patch}")
    if bias.shape != (b, hp, wp, num_heads * 2 * patch):
        raise ValueError(f"bias shape {tuple(bias.shape)} does not match "
                         f"qkv {tuple(qkv.shape)} and patch {patch}")
    if qkv.device.type == "cpu":
        return relpos_patch_attention_plain(qkv, bias, patch, num_heads,
                                            scale)
    if c3 != 3 * num_heads * hd or hd > 80 or hd % 8 or patch > 64:
        raise ValueError(f"relpos attention: head_dim {hd} must be a "
                         f"multiple of 8 and at most 80, patch <= 64")
    if bias.dtype != qkv.dtype:
        raise TypeError("relpos attention: bias and qkv dtypes differ")
    n_patches = b * (hp // patch) * (wp // patch)
    if n_patches > 65535:
        raise ValueError(f"relpos attention: {n_patches} patches exceed "
                         "the launch grid")
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    dev = kernels.check_cuda("relpos_patch_attention", qkv, bias, out)
    kernels.launch("ptk_relpos_patch_attention", qkv.data_ptr(),
                   bias.data_ptr(), out.data_ptr(), b, hp, wp, num_heads, hd,
                   patch, float(scale), kernels.dtype_code(qkv), device=dev)
    relpos_patch_attention.launches += 1
    return out


relpos_patch_attention.launches = 0


def window_packed_attention(qkv_pad: torch.Tensor, bias_pad: torch.Tensor,
                            win: int, num_heads: int,
                            scale: float) -> torch.Tensor:
    """Windowed ViTDet attention: qkv_pad (B, Hp, Wp, 3C) window-padded with
    the qkv projection's bias, bias_pad (B, Hp, Wp, nh·2·win).  Pad tokens
    take part as keys, as in the reference; pad query rows are computed and
    left for the caller to crop."""
    return relpos_patch_attention(qkv_pad, bias_pad, win, num_heads, scale)


def global_packed_attention(qkv: torch.Tensor, bias: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Global ViTDet attention over the whole square (B, H, H, 3C) grid with
    bias (B, H, H, nh·2H)."""
    if qkv.shape[1] != qkv.shape[2]:
        raise ValueError("global attention needs a square grid")
    return relpos_patch_attention(qkv, bias, qkv.shape[1], num_heads, scale)
