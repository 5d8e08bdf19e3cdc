"""Frozen copy of the analytic counts of the port's ``tools/roofline.py``
(``kernel_cost``, ``dino_seq``; its ``dino_flops`` and ``sam_flops`` are
the families' ``flops``, ``benchmark/families/``) and the published H100
SXM peaks: the yardstick the roofline and utilisation metrics divide by.

Peaks are NVIDIA's published figures for the H100 SXM (dense, no
sparsity), which assume the full 700 W power limit: 989 TFLOP/s bf16 and
1979 TOP/s int8 on the tensor cores, 67 TFLOP/s f32 on the CUDA cores,
3.35 TB/s of HBM.  Each run prints the card's own ``power.limit`` beside
its numbers.

``slice_flops`` sums a slice's model FLOP over the stages the encoders'
families count.  ``kernel_cost(name, **shapes)`` gives a kernel's (flops,
bytes, bound_ms, bound_by): bytes count each input read once and each
output written once; the bound is the larger of the flops over the peak of
the type they run in and the bytes over the HBM rate.
"""

from __future__ import annotations

from benchmark.harness import family

PEAK_BF16 = 989e12   # FLOP/s, tensor cores, dense
PEAK_INT8 = 1979e12  # OP/s, tensor cores, dense
PEAK_F32 = 67e12     # FLOP/s, CUDA cores
HBM_BYTES_S = 3.35e12
PEAKS_AT_W = 700


def dino_seq(n_tokens: int) -> int:
    """Sequence length the port's DINOv2 runs: padded to a 128 multiple
    from 2048 tokens on (``models/dinov2/vit.py``)."""
    return n_tokens + ((-n_tokens) % 128 if n_tokens >= 2048 else 0)


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


def slice_flops(cfg: dict, root=family.ROOT) -> tuple[float, float]:
    """(one coarse-encoder image, the SAM stages of one slice) in FLOP at
    a configuration's sizes, each the sum of its family's ``flops``."""
    c, s = cfg["coarse"], cfg["sam"]
    return (sum(family.load(c, root).flops(c).values()),
            sum(family.load(s, root).flops(s).values()))
