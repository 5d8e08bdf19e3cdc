"""Plain float32 building blocks over state dicts in a published key
layout, which the model families (``benchmark/families/``) assemble into
their encoders, and SAM's prompt encoder and mask decoder
(facebookresearch/segment-anything, ``modeling/prompt_encoder.py``,
``mask_decoder.py``, ``transformer.py``): random-Fourier prompt positions,
the two-way transformer and the hypernetwork mask head.

Key layouts are lists of ``(key, shape, role)``; the role picks the
synthetic weight recipe (``harness/weights.py``): ``norm`` (LayerNorm
weights and LayerScale gammas: 1 + 0.02·N), ``bias`` (0) or ``other``
(0.02·N; LayerNorm2d weights included).

Everything runs in float32 with plain ``torch`` operations and with TF32
off (``no_tf32``).  Nothing here imports the program under test.
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


def ln(x, w, p, eps):
    return F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"],
                        eps)


def lin(x, w, p):
    return F.linear(x, w[p + ".weight"], w[p + ".bias"])


def attend(q, k, v):
    """softmax(q kᵀ) v over (heads, n, d) with q already scaled."""
    return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v


def ln2d(x, w, p, eps=1e-6):
    """LayerNorm over the channels of (B, C, H, W)."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w[p + ".weight"][:, None, None] * x + w[p + ".bias"][:, None, None]


def mlp2(w, p, x, act):
    """``lin2(act(lin1(x)))`` of the MLP block under ``p``."""
    return lin(act(lin(x, w, p + "lin1")), w, p + "lin2")


def linear_keys(p, n_out, n_in):
    return [(p + ".weight", (n_out, n_in), "other"),
            (p + ".bias", (n_out,), "bias")]


def norm_keys(p, c):
    return [(p + ".weight", (c,), "norm"), (p + ".bias", (c,), "bias")]


def norm2d_keys(p, c):
    return [(p + ".weight", (c,), "other"), (p + ".bias", (c,), "bias")]


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
    q, k, v = lin(q, w, p + "q_proj"), lin(k, w, p + "k_proj"), \
        lin(v, w, p + "v_proj")
    b, n, c = q.shape

    def split(x):
        return x.reshape(b, x.shape[1], heads, c // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    out = attend(q / math.sqrt(c // heads), k, v)
    return lin(out.transpose(1, 2).reshape(b, n, c), w, p + "out_proj")


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
        queries = ln(queries, w, p + "norm1", 1e-5)
        q, k = queries + tokens, keys + key_pe
        queries = ln(queries + _dec_attention(
            w, p + "cross_attn_token_to_image.", q, k, keys), w,
            p + "norm2", 1e-5)
        mlp = mlp2(w, p + "mlp.", queries, torch.relu)
        queries = ln(queries + mlp, w, p + "norm3", 1e-5)
        q, k = queries + tokens, keys + key_pe
        keys = ln(keys + _dec_attention(
            w, p + "cross_attn_image_to_token.", k, q, queries), w,
            p + "norm4", 1e-5)
    q, k = queries + tokens, keys + key_pe
    queries = ln(queries + _dec_attention(
        w, t + "final_attn_token_to_image.", q, k, keys), w,
        t + "norm_final_attn", 1e-5)
    return queries, keys


def _mlp3(w, p, x):
    for j in range(3):
        x = lin(x, w, f"{p}.layers.{j}")
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
    up = F.gelu(ln2d(up, w, d + "output_upscaling.1"))
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
