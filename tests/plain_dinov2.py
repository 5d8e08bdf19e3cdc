"""Plain float32 DINOv2 over a hub-layout state dict, for the tests of the
port's ``models/dinov2/vit.py``: plain ``torch`` operations only (nothing of
either package, no JAX), TF32 off.

It follows facebookresearch/dinov2: ``dinov2/models/vision_transformer.py``
(``prepare_tokens_with_masks``, ``interpolate_pos_encoding``,
``forward_features``), ``dinov2/layers/block.py`` (pre-norm blocks with
LayerScale), ``dinov2/layers/attention.py``, ``dinov2/layers/mlp.py``
(fc1-GELU-fc2, exact GELU) and ``dinov2/layers/swiglu_ffn.py`` (the gated
FFN of ``vit_giant2``: ``x1, x2 = w12(x).chunk(2, -1)``, ``w3(silu(x1) *
x2)``, hidden ``(int(4·C·2/3) + 7) // 8 · 8``).  Departures, none of which
changes the mathematics:

* no ``masks`` argument (``mask_token`` is never used at inference);
* the sequence is not padded (the port pads it to a multiple of 128 from
  2048 tokens on and masks the padded keys);
* ``dense=`` may replace every block's ``F.linear``, which the int8
  control uses (``int8_linear``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Full float32 matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def swiglu_hidden(dim: int, mlp_ratio: float = 4.0) -> int:
    """``SwiGLUFFNFused``'s hidden width: 4096 at ViT-g's 1536."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def hub_layout(dim: int, depth: int, ffn: str = "mlp",
               mlp_ratio: float = 4.0, pos_grid: int = 37,
               patch: int = 14) -> dict[str, tuple]:
    """The hub model's ``state_dict`` keys and shapes, in order."""
    out = {"cls_token": (1, 1, dim), "pos_embed": (1, 1 + pos_grid ** 2, dim),
           "mask_token": (1, dim),
           "patch_embed.proj.weight": (dim, 3, patch, patch),
           "patch_embed.proj.bias": (dim,)}
    if ffn == "swiglu":
        h = swiglu_hidden(dim, mlp_ratio)
        fc = {"mlp.w12.weight": (2 * h, dim), "mlp.w12.bias": (2 * h,),
              "mlp.w3.weight": (dim, h), "mlp.w3.bias": (dim,)}
    else:
        h = int(dim * mlp_ratio)
        fc = {"mlp.fc1.weight": (h, dim), "mlp.fc1.bias": (h,),
              "mlp.fc2.weight": (dim, h), "mlp.fc2.bias": (dim,)}
    for i in range(depth):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": (dim,), b + "norm1.bias": (dim,),
                    b + "attn.qkv.weight": (3 * dim, dim),
                    b + "attn.qkv.bias": (3 * dim,),
                    b + "attn.proj.weight": (dim, dim),
                    b + "attn.proj.bias": (dim,), b + "ls1.gamma": (dim,),
                    b + "norm2.weight": (dim,), b + "norm2.bias": (dim,)})
        out.update({b + k: v for k, v in fc.items()})
        out[b + "ls2.gamma"] = (dim,)
    out.update({"norm.weight": (dim,), "norm.bias": (dim,)})
    return out


def _linear(w: dict, p: str, x: torch.Tensor, dense) -> torch.Tensor:
    return dense(x, w[p + ".weight"], w[p + ".bias"])


def gelu_mlp(w: dict, p: str, x: torch.Tensor, dense=F.linear):
    return _linear(w, p + "mlp.fc2",
                   F.gelu(_linear(w, p + "mlp.fc1", x, dense)), dense)


def swiglu_ffn(w: dict, p: str, x: torch.Tensor, dense=F.linear):
    x1, x2 = _linear(w, p + "mlp.w12", x, dense).chunk(2, dim=-1)
    return _linear(w, p + "mlp.w3", F.silu(x1) * x2, dense)


FFNS = {"mlp": gelu_mlp, "swiglu": swiglu_ffn}


def pos_embed(w: dict, gh: int, gw: int, offset: float = 0.1):
    """``interpolate_pos_encoding``: the pretrain grid resized bicubically
    in scale-factor mode with the hub's 0.1 offset."""
    pe = w["pos_embed"].float()
    m = int(round((pe.shape[1] - 1) ** 0.5))
    if (gh, gw) == (m, m):
        return pe
    grid = pe[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, mode="bicubic", align_corners=False,
                         scale_factor=((gh + offset) / m, (gw + offset) / m))
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
    return torch.cat([pe[:, :1], grid], dim=1)


def block(w: dict, i: int, x: torch.Tensor, heads: int, ffn: str = "mlp",
          dense=F.linear) -> torch.Tensor:
    """Block ``i`` on tokens (B, N, C)."""
    p = f"blocks.{i}."
    b, n, c = x.shape
    y = F.layer_norm(x, (c,), w[p + "norm1.weight"], w[p + "norm1.bias"],
                     1e-6)
    qkv = _linear(w, p + "attn.qkv", y, dense).reshape(
        b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    y = (torch.softmax(q @ k.transpose(-2, -1), dim=-1) @ v).transpose(
        1, 2).reshape(b, n, c)
    x = x + _linear(w, p + "attn.proj", y, dense) * w[p + "ls1.gamma"]
    y = F.layer_norm(x, (c,), w[p + "norm2.weight"], w[p + "norm2.bias"],
                     1e-6)
    return x + FFNS[ffn](w, p, y, dense) * w[p + "ls2.gamma"]


def forward(w: dict, x: torch.Tensor, heads: int, ffn: str = "mlp",
            patch: int = 14, dense=F.linear) -> torch.Tensor:
    """x (B, 3, H, W) -> ``x_norm_patchtokens`` (B, (H/14)(W/14), C)."""
    w = {k: v.float() for k, v in w.items()}
    depth = len({k.split(".")[1] for k in w if k.startswith("blocks.")})
    with no_tf32():
        gh, gw = x.shape[-2] // patch, x.shape[-1] // patch
        t = F.conv2d(x.float(), w["patch_embed.proj.weight"],
                     w["patch_embed.proj.bias"], stride=patch)
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([w["cls_token"].expand(t.shape[0], -1, -1), t], dim=1)
        t = t + pos_embed(w, gh, gw)
        for i in range(depth):
            t = block(w, i, t, heads, ffn, dense)
        t = F.layer_norm(t, (t.shape[-1],), w["norm.weight"], w["norm.bias"],
                         1e-6)
    return t[:, 1:]


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """A W8A8 dense layer: each row of the activations and of the weight
    quantized symmetrically (scale ``max(amax, 1e-12) / 127``, codes
    rounded half to even), the integer product (exact in float64), then
    ``((acc · sx) · sw) + b`` in float32."""
    def quantize(a):
        scale = a.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
        return torch.round(a / scale[:, None]), scale

    k = x.shape[-1]
    qx, sx = quantize(x.reshape(-1, k).float())
    qw, sw = quantize(weight.float())
    acc = (qx.double() @ qw.double().T).float()
    y = (acc * sx[:, None]) * sw[None, :] + bias.float()
    return y.reshape(*x.shape[:-1], weight.shape[0])
