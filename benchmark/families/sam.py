"""Family ``sam``: SAM's ViTDet image encoder as the refiner's encoder
(facebookresearch/segment-anything, ``modeling/image_encoder.py``), at a
configuration's ``sam`` section (``embed_dim``, ``depth``, ``num_heads``,
``global_attn_indexes``, ``window_size``, ``patch_size``, ``image_size``,
``prompt_embed_dim``).

ViTDet blocks, windows of 14 on a zero-padded grid and global blocks, the
decomposed relative-position bias, GELU MLPs of 4·C, the neck.  The layout
is the whole published ``Sam``: the image encoder, the prompt encoder and
the mask decoder, whose reference is shared
(``reference/models.sam_prompt_embeddings``, ``sam_decode``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import models as M

ENC = "image_encoder."


def keys(sec: dict, prefix: str) -> list:
    """The published ``Sam`` state-dict layout under ``prefix``."""
    c, heads = sec["embed_dim"], sec["num_heads"]
    patch, window = sec["patch_size"], sec["window_size"]
    out = sec["prompt_embed_dim"]
    g, hd = sec["image_size"] // patch, c // heads
    glob = set(sec["global_attn_indexes"])
    lin, norm, norm2d = M.linear_keys, M.norm_keys, M.norm2d_keys
    e = prefix + ENC
    layout = [(e + "pos_embed", (1, g, g, c), "other"),
              (e + "patch_embed.proj.weight", (c, 3, patch, patch), "other"),
              (e + "patch_embed.proj.bias", (c,), "bias")]
    for i in range(sec["depth"]):
        b = f"{e}blocks.{i}."
        side = g if i in glob else window
        layout += [*norm(b + "norm1", c),
                   (b + "attn.rel_pos_h", (2 * side - 1, hd), "other"),
                   (b + "attn.rel_pos_w", (2 * side - 1, hd), "other"),
                   *lin(b + "attn.qkv", 3 * c, c),
                   *lin(b + "attn.proj", c, c), *norm(b + "norm2", c),
                   *lin(b + "mlp.lin1", 4 * c, c),
                   *lin(b + "mlp.lin2", c, 4 * c)]
    layout += [(e + "neck.0.weight", (out, c, 1, 1), "other"),
               *norm2d(e + "neck.1", out),
               (e + "neck.2.weight", (out, out, 3, 3), "other"),
               *norm2d(e + "neck.3", out)]
    pe = prefix + "prompt_encoder."
    layout += [(pe + "pe_layer.positional_encoding_gaussian_matrix",
                (2, out // 2), "other")]
    layout += [(f"{pe}point_embeddings.{i}.weight", (1, out), "other")
               for i in range(4)]
    layout += [(pe + "not_a_point_embed.weight", (1, out), "other"),
               (pe + "mask_downscaling.0.weight", (4, 1, 2, 2), "other"),
               (pe + "mask_downscaling.0.bias", (4,), "bias"),
               *norm2d(pe + "mask_downscaling.1", 4),
               (pe + "mask_downscaling.3.weight", (16, 4, 2, 2), "other"),
               (pe + "mask_downscaling.3.bias", (16,), "bias"),
               *norm2d(pe + "mask_downscaling.4", 16),
               (pe + "mask_downscaling.6.weight", (out, 16, 1, 1), "other"),
               (pe + "mask_downscaling.6.bias", (out,), "bias"),
               (pe + "no_mask_embed.weight", (1, out), "other")]

    def attention(p, down):
        inner = out // down
        return [*lin(p + ".q_proj", inner, out),
                *lin(p + ".k_proj", inner, out),
                *lin(p + ".v_proj", inner, out),
                *lin(p + ".out_proj", out, inner)]

    t = prefix + "mask_decoder.transformer."
    for i in range(2):
        lay = f"{t}layers.{i}."
        layout += [*attention(lay + "self_attn", 1), *norm(lay + "norm1", out),
                   *attention(lay + "cross_attn_token_to_image", 2),
                   *norm(lay + "norm2", out),
                   *lin(lay + "mlp.lin1", 2048, out),
                   *lin(lay + "mlp.lin2", out, 2048),
                   *norm(lay + "norm3", out), *norm(lay + "norm4", out),
                   *attention(lay + "cross_attn_image_to_token", 2)]
    layout += [*attention(t + "final_attn_token_to_image", 2),
               *norm(t + "norm_final_attn", out)]
    d = prefix + "mask_decoder."
    layout += [(d + "iou_token.weight", (1, out), "other"),
               (d + "mask_tokens.weight", (4, out), "other"),
               (d + "output_upscaling.0.weight", (out, out // 4, 2, 2),
                "other"),
               (d + "output_upscaling.0.bias", (out // 4,), "bias"),
               *norm2d(d + "output_upscaling.1", out // 4),
               (d + "output_upscaling.3.weight", (out // 4, out // 8, 2, 2),
                "other"),
               (d + "output_upscaling.3.bias", (out // 8,), "bias")]
    for i in range(4):
        h = f"{d}output_hypernetworks_mlps.{i}.layers."
        layout += [*lin(h + "0", out, out), *lin(h + "1", out, out),
                   *lin(h + "2", out // 8, out)]
    h = d + "iou_prediction_head.layers."
    return layout + [*lin(h + "0", 256, out), *lin(h + "1", 256, 256),
                     *lin(h + "2", 4, 256)]


def forward(w: dict, x: torch.Tensor, sec: dict) -> torch.Tensor:
    """Preprocessed pixels (B, 3, S, S) -> the image embedding (B, 256,
    S/16, S/16), one image at a time; ``w`` holds the keys without the
    prefix."""
    enc = {k[len(ENC):]: v for k, v in w.items() if k.startswith(ENC)}
    glob = set(sec["global_attn_indexes"])
    with M.no_tf32():
        return torch.cat([_encode_one(enc, x[i:i + 1], sec, glob)
                          for i in range(x.shape[0])])


def _encode_one(w, x, sec, glob):
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=sec["patch_size"]).permute(0, 2, 3, 1)
    t = t + w["pos_embed"]
    for i in range(sec["depth"]):
        t = block(w, i, t, sec["num_heads"], i in glob, sec["window_size"])
    y = F.conv2d(t.permute(0, 3, 1, 2), w["neck.0.weight"])
    y = M.ln2d(y, w, "neck.1")
    y = F.conv2d(y, w["neck.2.weight"], padding=1)
    return M.ln2d(y, w, "neck.3")


def block(w: dict, i: int, t: torch.Tensor, heads: int, glob: bool,
          win: int = 14) -> torch.Tensor:
    """Block ``i`` on tokens (1, h, w, C); ``glob`` for a global block."""
    p = f"blocks.{i}."
    y = M.ln(t, w, p + "norm1", 1e-6)
    if glob:
        y = _attention(w, p + "attn.", y, heads)
    else:
        hw = y.shape[1:3]
        y, hw_pad = _windows(y, win)
        y = _attention(w, p + "attn.", y, heads)
        y = _unwindows(y, win, hw_pad, hw, 1)
    t = t + y
    y = M.ln(t, w, p + "norm2", 1e-6)
    return t + M.mlp2(w, p + "mlp.", y, F.gelu)


def _rel_table(rel_pos, size):
    """R[q, k] = rel_pos[q - k + size - 1] (equal query and key sizes)."""
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


def _attention(w, p, x, heads):
    """x (B, h, w, C) -> attention with the decomposed rel-pos bias."""
    b, h, wd, c = x.shape
    hd = c // heads
    qkv = M.lin(x, w, p + "qkv").reshape(b, h * wd, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * heads, h * wd, hd)
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    rh = _rel_table(w[p + "rel_pos_h"], h)
    rw = _rel_table(w[p + "rel_pos_w"], wd)
    rq = q.reshape(b * heads, h, wd, hd)
    bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    attn = (attn.view(b * heads, h, wd, h, wd) + bias_h[..., :, None]
            + bias_w[..., None, :]).view(b * heads, h * wd, h * wd)
    out = torch.softmax(attn, dim=-1) @ v
    out = out.view(b, heads, h, wd, hd).permute(0, 2, 3, 1, 4)
    return M.lin(out.reshape(b, h, wd, c), w, p + "proj")


def _windows(x, win):
    b, h, wd, c = x.shape
    ph, pw = (-h) % win, (-wd) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, wd + pw
    x = x.view(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def _unwindows(x, win, hw_pad, hw, b):
    hp, wp = hw_pad
    x = x.view(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


def flops(sec: dict) -> dict[str, float]:
    """One slice's model FLOP in SAM: dense GEMMs (with the decoder, about
    4 GFLOP at one component, counted as dense as the JAX tool does), the
    global blocks' QKᵀ + PV over all keys and their rel-pos bias einsums
    (every query against g rows and g columns of the table), and the
    windowed blocks' on ceil(g/win)² windows of the padded grid, their
    bias einsums on the unpadded grid."""
    c, depth, heads = sec["embed_dim"], sec["depth"], sec["num_heads"]
    n_global = len(sec["global_attn_indexes"])
    patch, win = sec["patch_size"], sec["window_size"]
    out = sec["prompt_embed_dim"]
    hd = c // heads
    g = sec["image_size"] // patch             # 64 at 1024
    s = g * g
    dense = 2 * s * (3 * c * c + c * c + 2 * 4 * c * c) * depth
    conv = 2 * s * (patch * patch * 3) * c
    neck = 2 * s * c * out + 2 * s * out * out * 9
    decode = 4e9
    glob = (2 * 2 * s * s * hd + 2 * s * hd * 2 * g) * heads * n_global
    nw = (-(-g // win)) ** 2
    sw = win * win
    wind = ((2 * 2 * sw * sw * hd * nw + 2 * s * hd * 2 * win) * heads
            * (depth - n_global))
    return {"sam dense gemms": dense + conv + neck + decode,
            "sam global attn": glob,
            "sam window attn": wind}
