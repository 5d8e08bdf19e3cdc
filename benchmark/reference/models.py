"""Plain float32 forward passes of the two published encoders and of SAM's
prompt encoder and mask decoder, written from their public descriptions
over state dicts in the published key layout:

* DINOv2 (facebookresearch/dinov2, ``dinov2/models/vision_transformer.py``):
  14-px patches, a cls token, the pretrain position grid resized bicubically
  with ``interpolate_offset`` 0.1 in scale-factor mode, pre-norm blocks with
  LayerScale, exact-GELU MLPs, a final LayerNorm (eps 1e-6 everywhere).
* SAM (facebookresearch/segment-anything, ``modeling/image_encoder.py``,
  ``prompt_encoder.py``, ``mask_decoder.py``, ``transformer.py``): ViTDet
  blocks, windows of 14 on a zero-padded grid and global blocks, the
  decomposed relative-position bias, the neck; random-Fourier prompt
  positions; the two-way transformer and the hypernetwork mask head.

Everything runs in float32 with plain ``torch`` operations and with TF32
off (``no_tf32``), one image at a time so that a full-size attention matrix
fits.  Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import math

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


def _ln(x, w, p, eps):
    return F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"],
                        eps)


def _lin(x, w, p):
    return F.linear(x, w[p + ".weight"], w[p + ".bias"])


def _attend(q, k, v):
    """softmax(q kᵀ) v over (heads, n, d) with q already scaled."""
    return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v


# ----------------------------------------------------------------- DINOv2


def dinov2_patch_tokens(w: dict, x: torch.Tensor, *, depth: int,
                        heads: int, patch: int = 14, pos_grid: int = 37,
                        offset: float = 0.1) -> torch.Tensor:
    """x (B, 3, H, W) -> final-norm patch tokens (B, (H/14)(W/14), C)."""
    out = []
    for i in range(x.shape[0]):
        t = _dinov2_one(w, x[i:i + 1], depth, heads, patch, pos_grid,
                        offset)
        out.append(t)
    return torch.cat(out)


def _dinov2_pos(w, gh, gw, m, offset):
    pe = w["pos_embed"]
    if (gh, gw) == (m, m):
        return pe
    grid = pe[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + offset) / m,
                                             (gw + offset) / m),
                         mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
    return torch.cat([pe[:, :1], grid], dim=1)


def _dinov2_one(w, x, depth, heads, patch, m, offset):
    _, _, h, wd = x.shape
    gh, gw = h // patch, wd // patch
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=patch).flatten(2).transpose(1, 2)
    t = torch.cat([w["cls_token"], t], dim=1) + _dinov2_pos(w, gh, gw, m,
                                                            offset)
    for i in range(depth):
        t = dinov2_block(w, i, t, heads)
    return _ln(t, w, "norm", 1e-6)[:, 1:]


def dinov2_block(w: dict, i: int, t: torch.Tensor,
                 heads: int) -> torch.Tensor:
    """Block ``i`` on tokens (1, n, C)."""
    p = f"blocks.{i}."
    c = t.shape[-1]
    hd = c // heads
    y = _ln(t, w, p + "norm1", 1e-6)
    qkv = _lin(y, w, p + "attn.qkv").reshape(-1, 3, heads, hd)
    q, k, v = qkv.permute(1, 2, 0, 3)
    y = _attend(q * hd ** -0.5, k, v).transpose(0, 1).reshape(1, -1, c)
    t = t + _lin(y, w, p + "attn.proj") * w[p + "ls1.gamma"]
    y = _ln(t, w, p + "norm2", 1e-6)
    y = _lin(F.gelu(_lin(y, w, p + "mlp.fc1")), w, p + "mlp.fc2")
    return t + y * w[p + "ls2.gamma"]


# ------------------------------------------------------------ SAM encoder


def _rel_table(rel_pos, size):
    """R[q, k] = rel_pos[q - k + size - 1] (equal query and key sizes)."""
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


def _sam_attention(w, p, x, heads):
    """x (B, h, w, C) -> attention with the decomposed rel-pos bias."""
    b, h, wd, c = x.shape
    hd = c // heads
    qkv = _lin(x, w, p + "qkv").reshape(b, h * wd, 3, heads, hd)
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
    return _lin(out.reshape(b, h, wd, c), w, p + "proj")


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


def _ln2d(x, w, p, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w[p + ".weight"][:, None, None] * x + w[p + ".bias"][:, None, None]


def sam_image_embedding(w: dict, x: torch.Tensor, *, depth: int,
                        heads: int, global_blocks, window: int = 14,
                        patch: int = 16) -> torch.Tensor:
    """Preprocessed pixels (B, 3, S, S) -> (B, 256, S/16, S/16); ``w`` holds
    the ``image_encoder.`` keys without the prefix."""
    return torch.cat([_sam_encode_one(w, x[i:i + 1], depth, heads,
                                      set(global_blocks), window, patch)
                      for i in range(x.shape[0])])


def _sam_encode_one(w, x, depth, heads, global_blocks, win, patch):
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=patch).permute(0, 2, 3, 1)
    t = t + w["pos_embed"]
    for i in range(depth):
        t = sam_block(w, i, t, heads, i in global_blocks, win)
    y = F.conv2d(t.permute(0, 3, 1, 2), w["neck.0.weight"])
    y = _ln2d(y, w, "neck.1")
    y = F.conv2d(y, w["neck.2.weight"], padding=1)
    return _ln2d(y, w, "neck.3")


def sam_block(w: dict, i: int, t: torch.Tensor, heads: int, glob: bool,
              win: int = 14) -> torch.Tensor:
    """Block ``i`` on tokens (1, h, w, C); ``glob`` for a global block."""
    p = f"blocks.{i}."
    y = _ln(t, w, p + "norm1", 1e-6)
    if glob:
        y = _sam_attention(w, p + "attn.", y, heads)
    else:
        hw = y.shape[1:3]
        y, hw_pad = _windows(y, win)
        y = _sam_attention(w, p + "attn.", y, heads)
        y = _unwindows(y, win, hw_pad, hw, 1)
    t = t + y
    y = _ln(t, w, p + "norm2", 1e-6)
    return t + _lin(F.gelu(_lin(y, w, p + "mlp.lin1")), w, p + "mlp.lin2")


# ------------------------------------------------- prompt encoder, decoder


def _fourier(w, coords01):
    c = (2.0 * coords01 - 1.0) @ w["prompt_encoder.pe_layer."
                                   "positional_encoding_gaussian_matrix"]
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def sam_prompt_embeddings(w: dict, coords: torch.Tensor,
                          labels: torch.Tensor, boxes: torch.Tensor | None,
                          image_size: int, grid: int):
    """Points (N, P, 2) xy with labels (N, P) in {1, 0, -1} and boxes
    (N, 4) | None -> (sparse (N, T, 256), dense (N, 256, grid, grid)); a
    padding point is appended when no box is given."""
    pe_ = "prompt_encoder."
    n = coords.shape[0]
    if boxes is None:
        coords = torch.cat([coords, coords.new_zeros(n, 1, 2)], dim=1)
        labels = torch.cat([labels, labels.new_full((n, 1), -1)], dim=1)
    pe = _fourier(w, (coords + 0.5) / image_size)
    lab = labels[..., None]
    pe = torch.where(lab == -1, 0.0, pe)
    pe = pe + (lab == -1) * w[pe_ + "not_a_point_embed.weight"][0]
    pe = pe + (lab == 0) * w[pe_ + "point_embeddings.0.weight"][0]
    pe = pe + (lab == 1) * w[pe_ + "point_embeddings.1.weight"][0]
    sparse = pe
    if boxes is not None:
        corners = _fourier(w, (boxes.reshape(-1, 2, 2) + 0.5) / image_size)
        corners = corners + torch.stack(
            [w[pe_ + "point_embeddings.2.weight"][0],
             w[pe_ + "point_embeddings.3.weight"][0]])
        sparse = torch.cat([sparse, corners], dim=1)
    dense = w[pe_ + "no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(
        n, -1, grid, grid)
    return sparse, dense


def _dense_pe(w, grid, device, dtype=torch.float32):
    c = (torch.arange(grid, dtype=dtype, device=device) + 0.5) / grid
    yy, xx = torch.meshgrid(c, c, indexing="ij")
    return _fourier(w, torch.stack([xx, yy], -1)).permute(2, 0, 1)[None]


def _dec_attention(w, p, q, k, v, heads=8):
    q, k, v = _lin(q, w, p + "q_proj"), _lin(k, w, p + "k_proj"), \
        _lin(v, w, p + "v_proj")
    b, n, c = q.shape

    def split(x):
        return x.reshape(b, x.shape[1], heads, c // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    out = _attend(q / math.sqrt(c // heads), k, v)
    return _lin(out.transpose(1, 2).reshape(b, n, c), w, p + "out_proj")


def _two_way(w, src, pos, tokens):
    t = "mask_decoder.transformer."
    keys = src.flatten(2).transpose(1, 2)
    key_pe = pos.flatten(2).transpose(1, 2)
    queries = tokens
    for i in range(2):
        p = f"{t}layers.{i}."
        if i == 0:
            queries = _dec_attention(w, p + "self_attn.", queries, queries,
                                     queries)
        else:
            q = queries + tokens
            queries = queries + _dec_attention(w, p + "self_attn.", q, q,
                                               queries)
        queries = _ln(queries, w, p + "norm1", 1e-5)
        q, k = queries + tokens, keys + key_pe
        queries = _ln(queries + _dec_attention(
            w, p + "cross_attn_token_to_image.", q, k, keys), w,
            p + "norm2", 1e-5)
        mlp = _lin(torch.relu(_lin(queries, w, p + "mlp.lin1")), w,
                   p + "mlp.lin2")
        queries = _ln(queries + mlp, w, p + "norm3", 1e-5)
        q, k = queries + tokens, keys + key_pe
        keys = _ln(keys + _dec_attention(
            w, p + "cross_attn_image_to_token.", k, q, queries), w,
            p + "norm4", 1e-5)
    q, k = queries + tokens, keys + key_pe
    queries = _ln(queries + _dec_attention(
        w, t + "final_attn_token_to_image.", q, k, keys), w,
        t + "norm_final_attn", 1e-5)
    return queries, keys


def _mlp3(w, p, x):
    for j in range(3):
        x = _lin(x, w, f"{p}.layers.{j}")
        if j < 2:
            x = torch.relu(x)
    return x


def sam_decode(w: dict, emb: torch.Tensor, sparse: torch.Tensor,
               dense: torch.Tensor, multimask: bool = False):
    """One embedding row per prompt set: emb, dense (N, 256, g, g), sparse
    (N, T, 256) -> (low-res logits (N, M, 4g, 4g), iou (N, M))."""
    d = "mask_decoder."
    b = sparse.shape[0]
    out_tokens = torch.cat([w[d + "iou_token.weight"],
                            w[d + "mask_tokens.weight"]])
    tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
    src = emb + dense
    _, c, h, wd = src.shape
    hs, src = _two_way(w, src, _dense_pe(w, h, emb.device, emb.dtype),
                       tokens)
    src = src.transpose(1, 2).reshape(b, c, h, wd)
    up = F.conv_transpose2d(src, w[d + "output_upscaling.0.weight"],
                            w[d + "output_upscaling.0.bias"], stride=2)
    up = F.gelu(_ln2d(up, w, d + "output_upscaling.1"))
    up = F.gelu(F.conv_transpose2d(up, w[d + "output_upscaling.3.weight"],
                                   w[d + "output_upscaling.3.bias"],
                                   stride=2))
    n_masks = w[d + "mask_tokens.weight"].shape[0]
    hyper = torch.stack([_mlp3(w, f"{d}output_hypernetworks_mlps.{i}",
                               hs[:, 1 + i]) for i in range(n_masks)], 1)
    masks = (hyper @ up.flatten(2)).reshape(b, n_masks, *up.shape[-2:])
    iou = _mlp3(w, d + "iou_prediction_head", hs[:, 0])
    if multimask:
        return masks[:, 1:], iou[:, 1:]
    return masks[:, :1], iou[:, :1]
