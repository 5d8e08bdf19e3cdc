"""JAX param trees of ``protosam_tpu`` -> the port's ``state_dict``s.

The inverse of ``protosam_tpu.utils.torch_convert.convert_sam`` /
``convert_dinov2`` / ``convert_deeplab_resnet101``: params are nested
dicts of numpy arrays.  Layout rules:

  Dense kernel (in, out)            -> Linear weight (out, in)
  Conv kernel HWIO (kh, kw, in, out) -> Conv2d weight OIHW
  ConvTranspose kernel (kh, kw, in, out), unflipped
                                    -> ConvTranspose2d weight (in, out, kh,
                                       kw), spatially flipped
  LayerNorm ``scale``               -> ``weight``
  ``nn.scan`` stacked ``blocks``    -> one entry per layer

SAM's rel-pos tables are stored padded to the largest layer in JAX; they
are cut back to 2·window-1 rows (windowed blocks) or 2·grid-1 rows
(global blocks).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv_t(sd, key, p):
    k = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)
    sd[f"{key}.weight"] = _t(k[:, :, ::-1, ::-1])
    sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"] if "scale" in p else p["weight"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _layers(stacked: Mapping) -> list[dict]:
    """Unstack the leading ``nn.scan`` axis of a nested param dict."""
    def depth(t):
        return (depth(next(iter(t.values()))) if isinstance(t, Mapping)
                else np.asarray(t).shape[0])

    def pick(t, i):
        return ({k: pick(v, i) for k, v in t.items()}
                if isinstance(t, Mapping) else np.asarray(t)[i])

    return [pick(stacked, i) for i in range(depth(stacked))]


def dinov2_state_dict(params: Mapping, prefix: str = ""
                      ) -> dict[str, torch.Tensor]:
    """DINOv2 flax params -> hub-layout state_dict (``mask_token``, unused
    at inference and absent in JAX, is filled with zeros)."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in params:
            sd[name] = _t(params[name])
    sd["mask_token"] = torch.zeros(1, np.asarray(params["cls_token"]).shape[-1])
    _conv(sd, "patch_embed.proj", params["patch_embed"])
    for i, blk in enumerate(_layers(params["blocks"])):
        b = f"blocks.{i}"
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _dense(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        sd[f"{b}.ls1.gamma"] = _t(blk["ls1"]["gamma"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _dense(sd, f"{b}.mlp.fc1", blk["mlp_fc1"])
        _dense(sd, f"{b}.mlp.fc2", blk["mlp_fc2"])
        sd[f"{b}.ls2.gamma"] = _t(blk["ls2"]["gamma"])
    _ln(sd, "norm", params["norm"])
    return {prefix + k: v for k, v in sd.items()}


def _bn(sd, key, p):
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{key}.{name}"] = _t(p[name])


def resnet_state_dict(params: Mapping, prefix: str = ""
                      ) -> dict[str, torch.Tensor]:
    """DeepLab ResNet-101 flax params -> the reference wrapper's layout
    (``backbone.<torchvision keys>``, ``localconv``), the keys JAX
    ``convert_deeplab_resnet101`` reads (``utils/torch_convert.py:235``)."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "backbone.conv1", params["conv1"])
    _bn(sd, "backbone.bn1", params["bn1"])
    for name, blk in params.items():
        if not name.startswith("layer"):
            continue
        li, bi = name[len("layer"):].split("_")
        b = f"backbone.layer{li}.{bi}"
        for i in (1, 2, 3):
            _conv(sd, f"{b}.conv{i}", blk[f"conv{i}"])
            _bn(sd, f"{b}.bn{i}", blk[f"bn{i}"])
        if "downsample_conv" in blk:
            _conv(sd, f"{b}.downsample.0", blk["downsample_conv"])
            _bn(sd, f"{b}.downsample.1", blk["downsample_bn"])
    _conv(sd, "localconv", params["localconv"])
    return {prefix + k: v for k, v in sd.items()}


def fewshot_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """FewShotSeg flax params (DINOv2 or ResNet-101 backbone) ->
    state_dict."""
    if "localconv" in params["encoder"]:
        return resnet_state_dict(params["encoder"], prefix="encoder.")
    return dinov2_state_dict(params["encoder"], prefix="encoder.")


def _two_way_attn(sd, key, p):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(sd, f"{key}.{proj}", p[proj])


def sam_state_dict(params: Mapping, global_attn_indexes: Sequence[int],
                   window_size: int = 14) -> dict[str, torch.Tensor]:
    """SAM flax params -> reference-layout state_dict."""
    sd: dict[str, torch.Tensor] = {}
    enc = params["image_encoder"]
    _conv(sd, "image_encoder.patch_embed.proj", enc["patch_embed"])
    sd["image_encoder.pos_embed"] = _t(enc["pos_embed"])
    grid = np.asarray(enc["pos_embed"]).shape[1]
    for i, blk in enumerate(_layers(enc["blocks"])):
        b = f"image_encoder.blocks.{i}"
        rows = 2 * (grid if i in global_attn_indexes else window_size) - 1
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _dense(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        for rel in ("rel_pos_h", "rel_pos_w"):
            sd[f"{b}.attn.{rel}"] = _t(np.asarray(blk["attn"][rel])[:rows])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _dense(sd, f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        _dense(sd, f"{b}.mlp.lin2", blk["mlp"]["lin2"])
    _conv(sd, "image_encoder.neck.0", enc["neck_conv1"])
    _ln(sd, "image_encoder.neck.1", enc["neck_ln1"])
    _conv(sd, "image_encoder.neck.2", enc["neck_conv2"])
    _ln(sd, "image_encoder.neck.3", enc["neck_ln2"])

    pe = params["prompt_encoder"]
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _t(
        pe["pe_layer"]["positional_encoding_gaussian_matrix"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = _t(
            pe[f"point_embeddings_{i}"])
    for name in ("not_a_point_embed", "no_mask_embed"):
        sd[f"prompt_encoder.{name}.weight"] = _t(pe[name])
    for idx, name, fn in (("0", "mask_down_conv1", _conv),
                          ("1", "mask_down_ln1", _ln),
                          ("3", "mask_down_conv2", _conv),
                          ("4", "mask_down_ln2", _ln),
                          ("6", "mask_down_conv3", _conv)):
        fn(sd, f"prompt_encoder.mask_downscaling.{idx}", pe[name])

    md = params["mask_decoder"]
    sd["mask_decoder.iou_token.weight"] = _t(md["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = _t(md["mask_tokens"])
    tr = md["transformer"]
    i = 0
    while f"layers_{i}" in tr:
        lp, key = tr[f"layers_{i}"], f"mask_decoder.transformer.layers.{i}"
        for attn in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            _two_way_attn(sd, f"{key}.{attn}", lp[attn])
        for n in range(1, 5):
            _ln(sd, f"{key}.norm{n}", lp[f"norm{n}"])
        _dense(sd, f"{key}.mlp.lin1", lp["mlp"]["lin1"])
        _dense(sd, f"{key}.mlp.lin2", lp["mlp"]["lin2"])
        i += 1
    _two_way_attn(sd, "mask_decoder.transformer.final_attn_token_to_image",
                  tr["final_attn_token_to_image"])
    _ln(sd, "mask_decoder.transformer.norm_final_attn", tr["norm_final_attn"])
    _conv_t(sd, "mask_decoder.output_upscaling.0", md["upscale_conv1"])
    _ln(sd, "mask_decoder.output_upscaling.1", md["upscale_ln"])
    _conv_t(sd, "mask_decoder.output_upscaling.3", md["upscale_conv2"])
    i = 0
    while f"output_hypernetworks_mlps_{i}" in md:
        mlp = md[f"output_hypernetworks_mlps_{i}"]
        for j in range(len(mlp)):
            _dense(sd, f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
                   mlp[f"layers_{j}"])
        i += 1
    head = md["iou_prediction_head"]
    for j in range(len(head)):
        _dense(sd, f"mask_decoder.iou_prediction_head.layers.{j}",
               head[f"layers_{j}"])
    return sd


def load_sam_pth(path: str) -> dict[str, torch.Tensor]:
    """A SAM / MedSAM ``.pth`` (reference build_sam.py:55-107 key names) as
    the state_dict of the port's ``build_sam`` module, which uses the same
    names; ``load_state_dict`` on the module is strict."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


# HF FFN names -> the hub's: fc1-GELU-fc2, and the gated FFN
_HF_FFN = (("fc1", "fc1"), ("fc2", "fc2"), ("weights_in", "w12"),
           ("weights_out", "w3"))


def hf_dinov2_to_hub_state_dict(sd: Mapping[str, torch.Tensor]
                                ) -> dict[str, torch.Tensor]:
    """A HuggingFace ``Dinov2Model`` state_dict in the facebook-hub layout
    of the port's DINOv2 (per-layer q/k/v fused back into qkv), as JAX
    ``utils/torch_convert.py:291`` maps it for its converter.  HF mirrors
    the hub weights (facebook/dinov2-large etc.) under other names; the
    gated FFN of ``facebook/dinov2-giant`` (``use_swiglu_ffn``) keeps the
    hub's packing under ``mlp.weights_in`` (the hub's ``w12``) and
    ``mlp.weights_out`` (``w3``)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out = {
        "cls_token": sd["embeddings.cls_token"],
        "pos_embed": sd["embeddings.position_embeddings"],
        "patch_embed.proj.weight":
            sd["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.proj.bias":
            sd["embeddings.patch_embeddings.projection.bias"],
        "norm.weight": sd["layernorm.weight"],
        "norm.bias": sd["layernorm.bias"],
    }
    if "embeddings.mask_token" in sd:
        out["mask_token"] = sd["embeddings.mask_token"]
    if "embeddings.register_tokens" in sd:
        out["register_tokens"] = sd["embeddings.register_tokens"]
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        p, b = f"encoder.layer.{i}.", f"blocks.{i}."
        for kind in ("weight", "bias"):
            out[f"{b}attn.qkv.{kind}"] = torch.cat(
                [sd[f"{p}attention.attention.{n}.{kind}"]
                 for n in ("query", "key", "value")])
            out[f"{b}attn.proj.{kind}"] = \
                sd[f"{p}attention.output.dense.{kind}"]
            for norm in ("norm1", "norm2"):
                out[f"{b}{norm}.{kind}"] = sd[f"{p}{norm}.{kind}"]
            for theirs, ours in _HF_FFN:
                if f"{p}mlp.{theirs}.{kind}" in sd:
                    out[f"{b}mlp.{ours}.{kind}"] = \
                        sd[f"{p}mlp.{theirs}.{kind}"]
        out[f"{b}ls1.gamma"] = sd[f"{p}layer_scale1.lambda1"]
        out[f"{b}ls2.gamma"] = sd[f"{p}layer_scale2.lambda1"]
        i += 1
    return out
