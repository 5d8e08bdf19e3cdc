"""The published state-dict layouts of the two models, key by key, with
each tensor's role in the synthetic weight recipe: ``norm`` (LayerNorm
weights and LayerScale gammas: 1 + 0.02·N), ``bias`` (0) or ``other``
(0.02·N; LayerNorm2d weights included).

* the coarse model is ALPNet around a DINOv2 ViT (facebookresearch/dinov2
  hub keys under ``encoder.``);
* SAM is facebookresearch/segment-anything's ``Sam`` (``image_encoder.``,
  ``prompt_encoder.``, ``mask_decoder.``).
"""

from __future__ import annotations


def _lin(p, n_out, n_in):
    return [(p + ".weight", (n_out, n_in), "other"),
            (p + ".bias", (n_out,), "bias")]


def _norm(p, c):
    return [(p + ".weight", (c,), "norm"), (p + ".bias", (c,), "bias")]


def _norm2d(p, c):
    return [(p + ".weight", (c,), "other"), (p + ".bias", (c,), "bias")]


def dinov2(prefix: str, embed: int, depth: int, pos_grid: int = 37,
           patch: int = 14, mlp_ratio: int = 4) -> list:
    c, p = embed, prefix
    keys = [(p + "cls_token", (1, 1, c), "other"),
            (p + "pos_embed", (1, 1 + pos_grid ** 2, c), "other"),
            (p + "mask_token", (1, c), "other"),
            (p + "patch_embed.proj.weight", (c, 3, patch, patch), "other"),
            (p + "patch_embed.proj.bias", (c,), "bias")]
    for i in range(depth):
        b = f"{p}blocks.{i}."
        keys += [*_norm(b + "norm1", c), *_lin(b + "attn.qkv", 3 * c, c),
                 *_lin(b + "attn.proj", c, c),
                 (b + "ls1.gamma", (c,), "norm"), *_norm(b + "norm2", c),
                 *_lin(b + "mlp.fc1", mlp_ratio * c, c),
                 *_lin(b + "mlp.fc2", c, mlp_ratio * c),
                 (b + "ls2.gamma", (c,), "norm")]
    return keys + _norm(p + "norm", c)


def sam(embed: int, depth: int, heads: int, global_blocks,
        image_size: int = 1024, patch: int = 16, window: int = 14,
        out: int = 256) -> list:
    c, g, hd = embed, image_size // patch, embed // heads
    e = "image_encoder."
    keys = [(e + "pos_embed", (1, g, g, c), "other"),
            (e + "patch_embed.proj.weight", (c, 3, patch, patch), "other"),
            (e + "patch_embed.proj.bias", (c,), "bias")]
    for i in range(depth):
        b = f"{e}blocks.{i}."
        side = g if i in global_blocks else window
        keys += [*_norm(b + "norm1", c),
                 (b + "attn.rel_pos_h", (2 * side - 1, hd), "other"),
                 (b + "attn.rel_pos_w", (2 * side - 1, hd), "other"),
                 *_lin(b + "attn.qkv", 3 * c, c),
                 *_lin(b + "attn.proj", c, c), *_norm(b + "norm2", c),
                 *_lin(b + "mlp.lin1", 4 * c, c),
                 *_lin(b + "mlp.lin2", c, 4 * c)]
    keys += [(e + "neck.0.weight", (out, c, 1, 1), "other"),
             *_norm2d(e + "neck.1", out),
             (e + "neck.2.weight", (out, out, 3, 3), "other"),
             *_norm2d(e + "neck.3", out)]
    pe = "prompt_encoder."
    keys += [(pe + "pe_layer.positional_encoding_gaussian_matrix",
              (2, out // 2), "other")]
    keys += [(f"{pe}point_embeddings.{i}.weight", (1, out), "other")
             for i in range(4)]
    keys += [(pe + "not_a_point_embed.weight", (1, out), "other"),
             (pe + "mask_downscaling.0.weight", (4, 1, 2, 2), "other"),
             (pe + "mask_downscaling.0.bias", (4,), "bias"),
             *_norm2d(pe + "mask_downscaling.1", 4),
             (pe + "mask_downscaling.3.weight", (16, 4, 2, 2), "other"),
             (pe + "mask_downscaling.3.bias", (16,), "bias"),
             *_norm2d(pe + "mask_downscaling.4", 16),
             (pe + "mask_downscaling.6.weight", (out, 16, 1, 1), "other"),
             (pe + "mask_downscaling.6.bias", (out,), "bias"),
             (pe + "no_mask_embed.weight", (1, out), "other")]

    def attention(p, down):
        inner = out // down
        return [*_lin(p + ".q_proj", inner, out),
                *_lin(p + ".k_proj", inner, out),
                *_lin(p + ".v_proj", inner, out),
                *_lin(p + ".out_proj", out, inner)]

    t = "mask_decoder.transformer."
    for i in range(2):
        lay = f"{t}layers.{i}."
        keys += [*attention(lay + "self_attn", 1), *_norm(lay + "norm1", out),
                 *attention(lay + "cross_attn_token_to_image", 2),
                 *_norm(lay + "norm2", out),
                 *_lin(lay + "mlp.lin1", 2048, out),
                 *_lin(lay + "mlp.lin2", out, 2048),
                 *_norm(lay + "norm3", out), *_norm(lay + "norm4", out),
                 *attention(lay + "cross_attn_image_to_token", 2)]
    keys += [*attention(t + "final_attn_token_to_image", 2),
             *_norm(t + "norm_final_attn", out)]
    d = "mask_decoder."
    keys += [(d + "iou_token.weight", (1, out), "other"),
             (d + "mask_tokens.weight", (4, out), "other"),
             (d + "output_upscaling.0.weight", (out, out // 4, 2, 2),
              "other"),
             (d + "output_upscaling.0.bias", (out // 4,), "bias"),
             *_norm2d(d + "output_upscaling.1", out // 4),
             (d + "output_upscaling.3.weight", (out // 4, out // 8, 2, 2),
              "other"),
             (d + "output_upscaling.3.bias", (out // 8,), "bias")]
    for i in range(4):
        h = f"{d}output_hypernetworks_mlps.{i}.layers."
        keys += [*_lin(h + "0", out, out), *_lin(h + "1", out, out),
                 *_lin(h + "2", out // 8, out)]
    h = d + "iou_prediction_head.layers."
    return keys + [*_lin(h + "0", 256, out), *_lin(h + "1", 256, 256),
                   *_lin(h + "2", 4, 256)]
