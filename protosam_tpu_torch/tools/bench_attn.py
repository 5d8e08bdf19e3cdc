"""ViTDet rel-pos attention, kernel K4, on the card: the counterpart of
``tools/bench_attn.py``.

K4 in the windowed (70 × 70 window-padded grid, 14 × 14 windows) and the
global (64 × 64) geometry at ViT-B (12 heads × 64) and ViT-H (16 × 80),
B = 8 images, bf16, against its plain version and against
``F.scaled_dot_product_attention`` with the rel-pos bias expanded to an
additive (patches, heads, P², P²) mask.  The mask, and the head-split,
window-partitioned q, k and v that SDPA takes, are built outside the
timing: the SDPA time is that of the attention alone, as K4's is.

At the timing inputs (qkv σ 0.3, bias σ 0.5) the scores spread by well
under one, and a kernel that read the bias at the wrong place would stay
inside the bf16 bound.  ``check_bias`` holds K4 on inputs from
``bias_check_inputs`` instead: qkv σ √2 and bias σ 2, so q·k·scale and
each bias factor have σ ≈ 2 (scores spread about 4).  There its mean error
against the plain version must stay under ``BIAS_SHARE`` of the mean
distance between the plain version and the plain version with bias_h and
bias_w swapped, and that swapped control must itself fail the bf16 bound,
which shows the inputs tell a right bias from a wrong one.

    python3 -m protosam_tpu_torch.tools.bench_attn [--reps 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from protosam_tpu_torch.ops.vitdet_flash import (
    _from_patches, _to_patches, relpos_patch_attention,
    relpos_patch_attention_plain)
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import (bf16_error, device_ms, log,
                                             require_cuda)

MODELS = {"vit_b": (12, 64), "vit_h": (16, 80)}
GEOMETRIES = {"window": (70, 14), "global": (64, 64)}  # (grid side, patch)
QKV_SIGMA, BIAS_SIGMA = 2 ** 0.5, 2.0  # q·k·scale and bias factors σ ≈ 2
BIAS_SHARE = 0.25


def bias_check_inputs(b: int, side: int, patch: int, nh: int, hd: int,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(qkv, bias) as float32 numpy arrays for ``check_bias``: qkv (b,
    side, side, 3·nh·hd) of σ √2, bias (b, side, side, nh·2·patch) of
    σ 2."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, side, side, 3 * nh * hd), dtype=np.float32)
    bias = rng.standard_normal((b, side, side, nh * 2 * patch),
                               dtype=np.float32)
    return qkv * np.float32(QKV_SIGMA), bias * np.float32(BIAS_SIGMA)


def swap_bias(bias: torch.Tensor, patch: int, num_heads: int) -> torch.Tensor:
    """The compact bias with bias_h and bias_w swapped in every head."""
    shape = bias.shape
    return bias.reshape(*shape[:-1], num_heads, 2, patch).flip(-2).reshape(
        shape)


def check_bias(qkv: torch.Tensor, bias: torch.Tensor, patch: int, nh: int,
               scale: float) -> dict:
    """Hold K4 against its f32 plain version at a score spread of about 4
    (see the module docstring); raises where it fails, or where the
    swapped-bias control does not.  Mean errors are over every output
    element."""
    args = (patch, nh, scale)
    want = relpos_patch_attention_plain(qkv.float(), bias.float(), *args)
    swapped = relpos_patch_attention_plain(
        qkv.float(), swap_bias(bias, patch, nh).float(), *args)
    got = relpos_patch_attention(qkv, bias, *args)
    err, tol = bf16_error(got, want)
    swap_err, _ = bf16_error(swapped, want)
    mean = lambda x: (x.float() - want).abs().mean().item()
    out = {"max_abs_err": err, "bound": tol, "mean_err": mean(got),
           "swap_mean_gap": mean(swapped), "swap_max_err": swap_err}
    if err > tol or out["mean_err"] > BIAS_SHARE * out["swap_mean_gap"]:
        raise AssertionError(f"K4 misreads the rel-pos bias: {out}")
    if swap_err <= tol:
        raise AssertionError(f"the swapped-bias control passes the bf16 "
                             f"bound: the inputs cannot tell: {out}")
    return out


def sdpa_operands(qkv: torch.Tensor, bias: torch.Tensor, patch: int,
                  num_heads: int) -> tuple[torch.Tensor, ...]:
    """(q, k, v, mask) for SDPA: (patches, heads, P², hd) each, and the
    additive mask (patches, heads, P², P²) with mask[q, k] = bias_h[q,
    row(k)] + bias_w[q, col(k)]."""
    c = qkv.shape[-1] // 3
    hd = c // num_heads
    tok = _to_patches(qkv, patch)                      # (N, P², 3C)
    n, pp = tok.shape[:2]
    heads = lambda t: t.reshape(n, pp, num_heads, hd).transpose(1, 2)
    q, k, v = (heads(tok[..., i * c:(i + 1) * c]).contiguous()
               for i in range(3))
    bb = _to_patches(bias, patch).reshape(n, pp, num_heads, 2, patch)
    bb = bb.transpose(1, 2)                            # (N, nh, P², 2, P)
    keys = torch.arange(pp, device=qkv.device)
    mask = bb[..., 0, keys // patch] + bb[..., 1, keys % patch]
    return q, k, v, mask.contiguous()


def sdpa_patches(q, k, v, mask, scale, b, side, patch) -> torch.Tensor:
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=scale)
    n, nh, pp, hd = out.shape
    return _from_patches(out.transpose(1, 2).reshape(n, pp, nh * hd), b,
                         side, side, patch)


def run(reps: int = 10, b: int = 8) -> dict:
    dev = require_cuda()
    rng = np.random.default_rng(0)
    out = {}
    for model, (nh, hd) in MODELS.items():
        for geom, (side, patch) in GEOMETRIES.items():
            c = nh * hd
            bf = lambda *s, sc: torch.from_numpy(
                rng.standard_normal(s, dtype=np.float32) * sc).to(
                device=dev, dtype=torch.bfloat16)
            qkv = bf(b, side, side, 3 * c, sc=0.3)
            bias = bf(b, side, side, nh * 2 * patch, sc=0.5)
            scale = hd ** -0.5
            args = (qkv, bias, patch, nh, scale)
            err, tol = bf16_error(relpos_patch_attention(*args),
                                  relpos_patch_attention_plain(*args))
            q, k, v, mask = sdpa_operands(qkv, bias, patch, nh)
            lib = lambda: sdpa_patches(q, k, v, mask, scale, b, side, patch)
            lib_err, _ = bf16_error(lib(), relpos_patch_attention_plain(
                *args))
            if err > tol:
                raise AssertionError(f"K4 {model} {geom}: {err} > {tol}")
            flops, _, bound_ms, bound_by = kernel_cost(
                "relpos_patch_attention", b=b, hp=side, wp=side, nh=nh,
                hd=hd, patch=patch)
            t = device_ms(lambda: relpos_patch_attention(*args), reps=reps)
            plain = device_ms(lambda: relpos_patch_attention_plain(*args),
                              reps=2, runs=3)
            sd = device_ms(lib, reps=reps)
            del q, k, v, mask
            big = (torch.from_numpy(x).to(device=dev, dtype=torch.bfloat16)
                   for x in bias_check_inputs(b, side, patch, nh, hd))
            chk = check_bias(*big, patch, nh, scale)
            out[f"{model} {geom}"] = {
                "ms": t.median_ms, "spread_ms": t.spread_ms,
                "plain_ms": plain.median_ms, "library_ms": sd.median_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err, "bias_check": chk}
            log(f"K4 {model} {geom} (B={b}, {side}x{side}, P={patch}, "
                f"{nh}x{hd}): kernel {t} = {flops / t.median_ms / 1e9:.1f} "
                f"TFLOP/s, {100 * bound_ms / t.median_ms:.1f}% of the "
                f"bound; plain {plain}; SDPA + additive mask {sd} "
                f"(err vs plain {lib_err:.2e}); bound {bound_ms:.4f} ms "
                f"({bound_by}); max_abs_err {err:.2e} (bound {tol:.2e}); "
                f"check_bias: mean err {chk['mean_err']:.2e} vs swapped "
                f"gap {chk['swap_mean_gap']:.2e}, max {chk['max_abs_err']:.2e}"
                f" (swapped {chk['swap_max_err']:.2e}, bound "
                f"{chk['bound']:.2e})")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
