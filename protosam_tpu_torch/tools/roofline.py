"""Analytic roofline of the pipeline and of every kernel on one H100: the
counterpart of ``tools/roofline.py``.

Peaks are NVIDIA's published figures for the H100 SXM (dense, no
sparsity), which assume the full 700 W power limit: 989 TFLOP/s bf16 and
1979 TOP/s int8 on the tensor cores, 67 TFLOP/s f32 on the CUDA cores, 3.35
TB/s of HBM.  A card
set below 700 W runs slower under load, so the tool prints the card's own
``power.limit`` beside them.  The JAX tool's ``PEAK_TFS = 190`` and its
``DEMONSTRATED_MS_*`` / ``MEASURED_MS_PER_SLICE`` tables are TPU
measurements and are not carried over.

``dino_flops`` / ``sam_flops`` count per pipeline stage.  Their dense-GEMM
counts equal the JAX tool's for the models both tools know; the gated FFN
of DINOv2 ViT-g/14 (``dinov2_g14``, which the JAX tool lacks) counts its
three matrices, w12 (two of them) and w3, at 3·h·C multiply-adds a token,
h the hub's hidden width (``SwiGLUFFN.hidden_features``).  Attention
counts the math the card runs: QKᵀ + PV over the real keys (DINOv2: every
padded query row against the ``n_valid`` real keys), plus, for SAM, the
einsums that build the compact rel-pos bias.  The JAX tool counted the TPU
kernels' augmented contraction lanes (K = hd + H + W) instead, so its
attention counts are larger.  ``dino_flops`` of the DeepLab ResNet-101
(``dlfcn_res101``) is ``resnet_flops``: its convolutions by stage.

``kernel_cost(name, **shapes)`` gives each kernel's (flops, bytes,
bound_ms, bound_by): bytes count each input read once and each output
written once; the bound is the larger of the flops over the peak of the
type they run in and the bytes over the HBM rate.  ``chip_smoke.py`` and
``PERF.md`` take every bound from it.

    python3 -m protosam_tpu_torch.tools.roofline [--sam vit_b]
        [--coarse dinov2_l14] [--image-size 672] [--batch 8]
        [--measured-ms MS]
"""

from __future__ import annotations

import argparse

from protosam_tpu_torch.models.backbones.resnet import (PUBLISHED_LAYERS,
                                                         PUBLISHED_WIDTHS)
from protosam_tpu_torch.models.dinov2.vit import FFNS

PEAK_BF16 = 989e12   # FLOP/s, tensor cores, dense
PEAK_INT8 = 1979e12  # OP/s, tensor cores, dense
PEAK_F32 = 67e12     # FLOP/s, CUDA cores
HBM_BYTES_S = 3.35e12
PEAKS_AT_W = 700

SAM_CFG = {
    # embed, depth, heads, n_global
    "vit_b": (768, 12, 12, 4),
    "vit_l": (1024, 24, 16, 4),
    "vit_h": (1280, 32, 16, 4),
}

DINO_CFG = {
    # embed, depth, heads, mlp_ratio, ffn (``models/dinov2/vit.FFNS``)
    "dinov2_l14": (1024, 24, 16, 4, "mlp"),
    "dinov2_b14": (768, 12, 12, 4, "mlp"),
    "dinov2_g14": (1536, 40, 24, 4, "swiglu"),
    "dinov2_t14": (192, 12, 3, 4, "mlp"),
}


def dino_seq(n_tokens: int) -> int:
    """Sequence length the port's DINOv2 runs: padded to a 128 multiple
    from 2048 tokens on (``models/dinov2/vit.py``)."""
    return n_tokens + ((-n_tokens) % 128 if n_tokens >= 2048 else 0)


RESNET_CFG = {"dlfcn_res101": (PUBLISHED_LAYERS, PUBLISHED_WIDTHS)}


def resnet_flops(name: str, image_size: int) -> dict[str, float]:
    """The dilated ResNet's convolutions on one image, 2 FLOP a
    multiply-add, by stage (``models/backbones/resnet.py``: the stem and
    max-pool halve the side twice, layer2 once; layer3 and layer4 dilate);
    BatchNorm, ReLU and the residual adds are not counted."""
    layers, widths = RESNET_CFG[name]

    def conv(side, cin, cout, k):
        return 2 * side * side * cin * cout * k * k

    side = -(-image_size // 2)
    out = {"resnet stem": float(conv(side, 3, widths[0], 7))}
    side, cin = -(-side // 2), widths[0]
    for li, (n, planes) in enumerate(zip(layers, widths), start=1):
        stride = 2 if li == 2 else 1
        below, f = -(-side // stride), 0
        for bi in range(n):
            f += (conv(side if bi == 0 else below, cin, planes, 1)
                  + conv(below, planes, planes, 3)
                  + conv(below, planes, 4 * planes, 1))
            if bi == 0 and (stride != 1 or cin != 4 * planes):
                f += conv(below, cin, 4 * planes, 1)
            cin = 4 * planes
        out[f"resnet layer{li}"] = float(f)
        side = below
    out["resnet localconv"] = float(conv(side, cin, 256, 1))
    return out


def dino_flops(name: str, image_size: int) -> dict[str, float]:
    """The coarse encoder's FLOP on one image by stage."""
    if name in RESNET_CFG:
        return resnet_flops(name, image_size)
    c, depth, heads, mlp, ffn = DINO_CFG[name]
    hd = c // heads
    grid = image_size // 14
    n_tokens = grid * grid + 1
    s = dino_seq(n_tokens)
    h = FFNS[ffn].hidden_features(c, mlp)
    # multiply-adds a token: fc1 and fc2, or the gated w12 (2h) and w3
    ffn_weights = (3 if ffn == "swiglu" else 2) * h * c
    dense = 2 * s * (3 * c * c + c * c + ffn_weights) * depth
    attn = 2 * 2 * s * n_tokens * hd * heads * depth  # QKᵀ + PV, real keys
    patch = 2 * grid * grid * (14 * 14 * 3) * c
    return {"dinov2 dense gemms": dense + patch, "dinov2 attention": attn}


def sam_flops(ver: str, image_size: int = 1024,
              win: int = 14) -> dict[str, float]:
    c, depth, heads, n_global = SAM_CFG[ver]
    hd = c // heads
    g = image_size // 16                       # 64 at 1024
    s = g * g
    dense = 2 * s * (3 * c * c + c * c + 2 * 4 * c * c) * depth
    patch = 2 * s * (16 * 16 * 3) * c
    neck = 2 * s * c * 256 + 2 * s * 256 * 256 * 9
    # decode: prompt encoder + 2-layer two-way transformer + upscale,
    # ~4 GF/slice at one component, counted as dense (as the JAX tool does)
    decode = 4e9
    # global layers: QKᵀ + PV over all s keys, and the bias einsums
    # (every query against g rows and g columns of the rel-pos table)
    glob = (2 * 2 * s * s * hd + 2 * s * hd * 2 * g) * heads * n_global
    # windowed layers: ceil(g/win)^2 windows of win^2 tokens on the padded
    # grid; the bias einsums run on the unpadded grid
    nw = (-(-g // win)) ** 2
    sw = win * win
    wind = ((2 * 2 * sw * sw * hd * nw + 2 * s * hd * 2 * win) * heads
            * (depth - n_global))
    return {"sam dense gemms": dense + patch + neck + decode,
            "sam global attn": glob,
            "sam window attn": wind}


# ------------------------------------------------------------ kernels


def _peak(itemsize: int) -> float:
    return {1: PEAK_INT8, 2: PEAK_BF16}.get(itemsize, PEAK_F32)


def _layer_norm_rows(rows, c, itemsize=2, out_itemsize=None):
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    # mean, mean of squares, centre, scale, shift: ~8 f32 ops per element
    return (8 * rows * c, rows * c * (itemsize + out_itemsize) + 2 * c * 4,
            PEAK_F32)


def _packed_masked_attention(b, s, nh, hd, n_valid=None, itemsize=2):
    n_valid = s if n_valid is None else n_valid
    c = nh * hd
    return (4 * b * nh * s * n_valid * hd,
            b * s * (3 * c + c) * itemsize, _peak(itemsize))


def _relpos_patch_attention(b, hp, wp, nh, hd, patch, itemsize=2):
    n = b * (hp // patch) * (wp // patch)
    c = nh * hd
    return (4 * n * patch ** 4 * hd * nh,
            b * hp * wp * (3 * c + nh * 2 * patch + c) * itemsize,
            _peak(itemsize))


def _cca_label(b, h, w):
    # integer work, not counted: uint8 mask in, int32 labels out
    return 0, b * h * w * (1 + 4), PEAK_F32


def _alp_match(n, c, hw, p):
    # the cosine products on exact f32 FMAs; f32 query, prototypes and
    # output, one byte of validity per prototype
    return (2 * n * hw * p * c, (n * c * hw + p * c + n * hw) * 4 + p,
            PEAK_F32)


def _dense_residual(m, k, n):
    return 2 * m * k * n, 2 * (m * k + n * k + n + 2 * m * n), PEAK_BF16


def _mlp_fused(m, c, h, residual=True):
    acts = (3 if residual else 2) * m * c
    return 4 * m * c * h, 2 * (acts + 2 * h * c + h + c), PEAK_BF16


def _quantize_rows(rows, k, itemsize=2):
    # |x|, the max, the divide and the rounding: ~4 f32 ops per element;
    # the rows in, the codes and a scale per row out
    return 4 * rows * k, rows * k * (itemsize + 1) + 4 * rows, PEAK_F32


def _quantize_operands(m, n, k, x_itemsize=2, w_itemsize=4):
    # K8 on both operands of a layer in one launch: each row set as above
    fx, bx, _ = _quantize_rows(m, k, x_itemsize)
    fw, bw, _ = _quantize_rows(n, k, w_itemsize)
    return fx + fw, bx + bw, PEAK_F32


def _int8_dense(m, k, n, out_itemsize=2, bias=True):
    # the int8 product on the tensor cores; the codes, both scales and the
    # bias in, the dequantized output out
    return (2 * m * k * n,
            (m + n) * k + 4 * (m + n + (n if bias else 0))
            + m * n * out_itemsize, _peak(1))


_COSTS = {
    "layer_norm_rows": _layer_norm_rows,
    "packed_masked_attention": _packed_masked_attention,
    "relpos_patch_attention": _relpos_patch_attention,
    "cca_label": _cca_label,
    "alp_match": _alp_match,
    "dense_residual": _dense_residual,
    "mlp_fused": _mlp_fused,
    "quantize_rows": _quantize_rows,
    "quantize_operands": _quantize_operands,
    "int8_dense": _int8_dense,
}


def kernel_cost(name: str, **shapes) -> tuple[float, float, float, str]:
    """(flops, bytes, bound_ms, bound_by) of kernel ``name`` at ``shapes``;
    ``bound_by`` is "operations" or "bytes", whichever takes longer at the
    published peaks."""
    flops, nbytes, peak = _COSTS[name](**shapes)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return float(flops), float(nbytes), max(t_ops, t_bytes) * 1e3, by


# every kernel at the main-path shapes that ``chip_smoke.py`` phase 2 holds
# it to, at B = 2 slices; phase 2 builds its inputs from this table
MAIN_PATH_SHAPES = {
    "K1 DINOv2-L rows": ("layer_norm_rows", dict(rows=2 * 2432, c=1024)),
    "K1 SAM-B rows": ("layer_norm_rows", dict(rows=2 * 4096, c=768)),
    "K1 SAM-H rows": ("layer_norm_rows", dict(rows=2 * 4096, c=1280)),
    "K2 DINOv2-L": ("packed_masked_attention",
                    dict(b=2, s=2432, nh=16, hd=64, n_valid=2305)),
    "K3 five 1024^2 masks": ("cca_label", dict(b=5, h=1024, w=1024)),
    "K4 ViT-B window": ("relpos_patch_attention",
                        dict(b=2, hp=70, wp=70, nh=12, hd=64, patch=14)),
    "K4 ViT-B global": ("relpos_patch_attention",
                        dict(b=2, hp=64, wp=64, nh=12, hd=64, patch=64)),
    "K4 ViT-H window": ("relpos_patch_attention",
                        dict(b=2, hp=70, wp=70, nh=16, hd=80, patch=14)),
    "K4 ViT-H global": ("relpos_patch_attention",
                        dict(b=2, hp=64, wp=64, nh=16, hd=80, patch=64)),
    "K5 P = 576": ("alp_match", dict(n=4, c=1024, hw=2304, p=576)),
    "K5 P = 577": ("alp_match", dict(n=4, c=1024, hw=2304, p=577)),
    "K6 ViT-H proj": ("dense_residual", dict(m=2 * 4096, k=1280, n=1280)),
    "K7 ViT-H MLP": ("mlp_fused", dict(m=2 * 4096, c=1280, h=5120)),
    # the int8 flagship's dense stages at slice_batch 4: DINOv2-L (4 x 2432
    # padded tokens; qkv 1024 -> 3072, fc1 1024 -> 4096, fc2 4096 -> 1024)
    # and SAM ViT-B (4 x 4096 tokens; qkv 768 -> 2304, fc2 3072 -> 768); K8
    # on the bf16 activations and the f32 weight, apart and in the one
    # launch a layer makes
    "K8 DINOv2-L fc2 rows": ("quantize_rows",
                             dict(rows=4 * 2432, k=4096, itemsize=2)),
    "K8 DINOv2-L fc2 weight": ("quantize_rows",
                               dict(rows=1024, k=4096, itemsize=4)),
    "K8 SAM-B qkv rows": ("quantize_rows",
                          dict(rows=4 * 4096, k=768, itemsize=2)),
    "K8 SAM-B qkv weight": ("quantize_rows",
                            dict(rows=2304, k=768, itemsize=4)),
    "K8 ragged": ("quantize_rows", dict(rows=9221, k=1040, itemsize=2)),
    "K8 DINOv2-L fc2 operands": ("quantize_operands",
                                 dict(m=4 * 2432, n=1024, k=4096)),
    "K9 DINOv2-L fc2": ("int8_dense", dict(m=4 * 2432, k=4096, n=1024)),
    "K9 DINOv2-L qkv": ("int8_dense", dict(m=4 * 2432, k=1024, n=3072)),
    "K9 DINOv2-L fc1": ("int8_dense", dict(m=4 * 2432, k=1024, n=4096)),
    "K9 SAM-B qkv": ("int8_dense", dict(m=4 * 4096, k=768, n=2304)),
    "K9 SAM-B fc2": ("int8_dense", dict(m=4 * 4096, k=3072, n=768)),
    # ragged: M and N not multiples of the 128 x 256 tile, K ends inside
    # a 128-byte stage
    "K9 ragged": ("int8_dense", dict(m=9221, k=1040, n=1000)),
}


def tool_shapes() -> dict:
    """Rows 13 and 14 of the kernel table at their tools' own shapes."""
    from protosam_tpu_torch.tools import bench_fc2, microbench_attn as mb

    return {
        "row 13 fc2": ("dense_residual",
                       dict(m=bench_fc2.M, k=bench_fc2.K, n=bench_fc2.N)),
        "row 14 microbench_attn": ("packed_masked_attention",
                                   dict(b=mb.B, s=mb.S, nh=mb.NH, hd=mb.HD,
                                        n_valid=mb.N_VALID)),
    }


def main(argv: list[str] | None = None) -> dict:
    from protosam_tpu_torch.tools.timing import card, require_cuda

    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coarse", default="dinov2_l14")
    ap.add_argument("--sam", default="vit_b")
    ap.add_argument("--image-size", type=int, default=672)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="measured device ms for one slice batch")
    args = ap.parse_args(argv)

    print(f"published H100 SXM peaks at {PEAKS_AT_W} W: "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16, {PEAK_F32 / 1e12:.0f} "
          f"TFLOP/s f32, {HBM_BYTES_S / 1e12:.2f} TB/s; this card: {card()}",
          flush=True)
    parts = {**dino_flops(args.coarse, args.image_size),
             **sam_flops(args.sam)}
    b = args.batch
    print(f"config: {args.coarse} + {args.sam} @ {args.image_size} px, "
          f"slice batch {b}")
    print(f"{'stage':<28}{'TFLOP/batch':>14}{'ms at bf16 peak':>18}")
    ideal_ms = 0.0
    for name, f in parts.items():
        ms = f * b / PEAK_BF16 * 1e3
        ideal_ms += ms
        print(f"{name:<28}{f * b / 1e12:>14.3f}{ms:>18.3f}")
    print(f"{'total':<28}{sum(parts.values()) * b / 1e12:>14.3f}"
          f"{ideal_ms:>18.3f}")
    if args.measured_ms:
        print(f"measured {args.measured_ms:.1f} ms/batch: "
              f"{100 * ideal_ms / args.measured_ms:.1f}% of the bf16 "
              f"compute bound [{card()}]")
    print(f"\n{'kernel at main-path shape':<26}{'GFLOP':>10}{'MB':>10}"
          f"{'bound ms':>11}  bound by")
    bounds = {}
    for label, (name, shapes) in {**MAIN_PATH_SHAPES,
                                  **tool_shapes()}.items():
        flops, nbytes, ms, by = kernel_cost(name, **shapes)
        bounds[label] = (ms, by)
        print(f"{label:<26}{flops / 1e9:>10.2f}{nbytes / 1e6:>10.1f}"
              f"{ms:>11.4f}  {by}")
    return {"stages": parts, "ideal_ms": ideal_ms, "bounds": bounds}


if __name__ == "__main__":
    main()
