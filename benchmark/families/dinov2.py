"""Family ``dinov2``: DINOv2 as the coarse encoder (facebookresearch/dinov2,
``dinov2/models/vision_transformer.py``), at a configuration's ``coarse``
section (``embed_dim``, ``depth``, ``num_heads``, ``mlp_ratio``,
``patch_size``, ``pos_grid``, ``input_size``).

14-px patches, a cls token, the pretrain position grid resized bicubically
with ``interpolate_offset`` 0.1 in scale-factor mode, pre-norm blocks with
LayerScale, exact-GELU MLPs, a final LayerNorm (eps 1e-6 everywhere).

The published variants differ from this in the register tokens, the
resize and the FFN.  A family of such a variant imports this file
(``from benchmark.families import dinov2``) and passes what differs:
``registers``, ``offset`` and ``antialias``, or its own ``mlp`` /
``mlp_keys`` / ``ffn_weights``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.harness.roofline import dino_seq
from benchmark.reference import models as M


def fc_keys(b: str, c: int, sec: dict) -> list:
    """fc1-GELU-fc2 of block prefix ``b``."""
    hidden = sec["mlp_ratio"] * c
    return [*M.linear_keys(b + "mlp.fc1", hidden, c),
            *M.linear_keys(b + "mlp.fc2", c, hidden)]


def keys(sec: dict, prefix: str, *, registers: int = 0,
         mlp_keys=fc_keys) -> list:
    """The hub's state-dict layout under ``prefix``."""
    c, p, patch = sec["embed_dim"], prefix, sec["patch_size"]
    out = [(p + "cls_token", (1, 1, c), "other"),
           (p + "pos_embed", (1, 1 + sec["pos_grid"] ** 2, c), "other")]
    if registers:
        out.append((p + "register_tokens", (1, registers, c), "other"))
    out += [(p + "mask_token", (1, c), "other"),
            (p + "patch_embed.proj.weight", (c, 3, patch, patch), "other"),
            (p + "patch_embed.proj.bias", (c,), "bias")]
    for i in range(sec["depth"]):
        b = f"{p}blocks.{i}."
        out += [*M.norm_keys(b + "norm1", c),
                *M.linear_keys(b + "attn.qkv", 3 * c, c),
                *M.linear_keys(b + "attn.proj", c, c),
                (b + "ls1.gamma", (c,), "norm"), *M.norm_keys(b + "norm2", c),
                *mlp_keys(b, c, sec),
                (b + "ls2.gamma", (c,), "norm")]
    return out + M.norm_keys(p + "norm", c)


def gelu_mlp(w: dict, p: str, y: torch.Tensor) -> torch.Tensor:
    """fc2(GELU(fc1(y))) of block prefix ``p``."""
    return M.lin(F.gelu(M.lin(y, w, p + "mlp.fc1")), w, p + "mlp.fc2")


def forward(w: dict, x: torch.Tensor, sec: dict, *, registers: int = 0,
            offset: float = 0.1, antialias: bool = False,
            mlp=gelu_mlp) -> torch.Tensor:
    """x (B, 3, H, W) -> final-norm patch tokens (B, (H/14)(W/14), C), one
    image at a time; ``w`` holds the keys without the prefix."""
    out = []
    with M.no_tf32():
        for i in range(x.shape[0]):
            t = embed(w, x[i:i + 1], sec, offset, antialias)
            if registers:
                t = torch.cat([t[:, :1], w["register_tokens"], t[:, 1:]],
                              dim=1)
            for j in range(sec["depth"]):
                t = block(w, j, t, sec["num_heads"], mlp)
            out.append(M.ln(t, w, "norm", 1e-6)[:, 1 + registers:])
    return torch.cat(out)


def pos(w: dict, gh: int, gw: int, m: int, offset: float = 0.1,
        antialias: bool = False) -> torch.Tensor:
    """The position embedding on a (gh, gw) grid: the hub's
    ``interpolate_pos_encoding``, in scale-factor mode where ``offset`` is
    set and in size mode where it is 0."""
    pe = w["pos_embed"]
    if (gh, gw) == (m, m):
        return pe
    grid = pe[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    if offset:
        size = {"scale_factor": ((gh + offset) / m, (gw + offset) / m)}
    else:
        size = {"size": (gh, gw)}
    grid = F.interpolate(grid, mode="bicubic", align_corners=False,
                         antialias=antialias, **size)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
    return torch.cat([pe[:, :1], grid], dim=1)


def embed(w: dict, x: torch.Tensor, sec: dict, offset: float = 0.1,
          antialias: bool = False) -> torch.Tensor:
    """One image (1, 3, H, W) -> the cls and patch tokens with their
    positions, (1, 1 + gh·gw, C)."""
    patch = sec["patch_size"]
    _, _, h, wd = x.shape
    gh, gw = h // patch, wd // patch
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=patch).flatten(2).transpose(1, 2)
    return torch.cat([w["cls_token"], t], dim=1) + pos(
        w, gh, gw, sec["pos_grid"], offset, antialias)


def block(w: dict, i: int, t: torch.Tensor, heads: int,
          mlp=gelu_mlp) -> torch.Tensor:
    """Block ``i`` on tokens (1, n, C)."""
    p = f"blocks.{i}."
    c = t.shape[-1]
    hd = c // heads
    y = M.ln(t, w, p + "norm1", 1e-6)
    qkv = M.lin(y, w, p + "attn.qkv").reshape(-1, 3, heads, hd)
    q, k, v = qkv.permute(1, 2, 0, 3)
    y = M.attend(q * hd ** -0.5, k, v).transpose(0, 1).reshape(1, -1, c)
    t = t + M.lin(y, w, p + "attn.proj") * w[p + "ls1.gamma"]
    y = M.ln(t, w, p + "norm2", 1e-6)
    return t + mlp(w, p, y) * w[p + "ls2.gamma"]


def tokens(sec: dict, registers: int = 0) -> int:
    """The real tokens of the sequence: patches, cls and registers."""
    grid = sec["input_size"] // sec["patch_size"]
    return grid * grid + 1 + registers


def flops(sec: dict, *, registers: int = 0,
          ffn_weights: int | None = None) -> dict[str, float]:
    """One image's model FLOP: dense GEMMs (the FFN as ``ffn_weights``
    multiply-adds a token, fc1 and fc2 by default) and attention as QKᵀ +
    PV of every query row the program runs (``dino_seq``) against the real
    keys."""
    c, depth, heads = sec["embed_dim"], sec["depth"], sec["num_heads"]
    if ffn_weights is None:
        ffn_weights = 2 * sec["mlp_ratio"] * c * c
    hd = c // heads
    patch = sec["patch_size"]
    grid = sec["input_size"] // patch
    n_tokens = tokens(sec, registers)
    s = dino_seq(n_tokens)
    dense = 2 * s * (3 * c * c + c * c + ffn_weights) * depth
    attn = 2 * 2 * s * n_tokens * hd * heads * depth  # QKᵀ + PV, real keys
    conv = 2 * grid * grid * (patch * patch * 3) * c
    return {"dinov2 dense gemms": dense + conv, "dinov2 attention": attn}
