"""DINOv2 packed attention variants at the production shape on the card:
the counterpart of ``tools/microbench_attn.py`` (``build`` :149), at its
shape (``:33-36``): qkv (8, 2432, 3·1024) bf16, 16 heads × 64, keys from
2305 on masked.

The JAX tool's v0, v1 and v2 are one function: exact f32 scores, pad keys
excluded, the softmax normalised by the bf16 weights that PV uses.  v1's
ones lane (the row sum folded into PV) and v2's augmented K lane (the mask
folded into the score product) are packing tricks for the TPU's MXU; v2
also folds the scale into q before rounding, which at head dim 64
(scale 0.125) is exact.  So kernel K2 runs once for all three.  v3 keeps
the scores in bf16 and is a different function: it runs on K2's bf16-score
instantiation (``score_dtype=torch.bfloat16``).  Each is timed on the JAX
tool's input and printed with ``max|Δ vs v0|`` over the valid rows, as the
JAX tool prints it (``:206-214``).

On that input the scores have a spread of about 0.25, where v3's roundings
move the output by less than the bf16 bound, so a kernel that skipped them
would pass as v3 there.  ``check_v3`` therefore holds the bf16-score
kernel on the same input times ``LOGIT_SCALE`` (scores spread about 4,
where rounding a score to bf16 moves its weight by percent): its mean
error against the plain v3 must stay under ``V3_SHARE`` of the plain v0's
mean distance from the plain v3, and K2 itself (f32 scores) must fail
that test on the same input, which shows the test tells the two functions
apart.

Beside them, as the library yardstick, ``F.scaled_dot_product_attention``
on head-split views of q with k and v sliced to the first n_valid keys:
the same function without a mask, so the flash backend is eligible.

    python3 -m protosam_tpu_torch.tools.microbench_attn [--reps 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from protosam_tpu_torch.ops.attention import (masked_attention_packed_plain,
                                              masked_flash_attention_packed)
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import (bf16_error, device_ms, log,
                                             require_cuda)

B, S, NH, HD = 8, 2432, 16, 64
N_VALID = 2305
C = NH * HD
SCALE = HD ** -0.5
LOGIT_SCALE = 4.0  # qkv x 4: scores spread ~4 instead of ~0.25
V3_SHARE = 0.25

# variant -> its score dtype; K2 runs both
VARIANTS = {"v0-v2": torch.float32, "v3": torch.bfloat16}


def qkv_input(b: int = B, s: int = S, c: int = C, seed: int = 0
              ) -> np.ndarray:
    """The JAX tool's input, float64: N(0, 0.5²) of shape (b, s, 3c)."""
    return np.random.default_rng(seed).standard_normal((b, s, 3 * c)) * 0.5


def sdpa(qkv: torch.Tensor, num_heads: int, n_valid: int,
         scale: float) -> torch.Tensor:
    """One ``scaled_dot_product_attention`` call on head-split views of the
    packed qkv, keys and values sliced to the first ``n_valid``; returns
    (B, S, C)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    heads = lambda t: t.view(b, s, num_heads, c // num_heads).transpose(1, 2)
    q = heads(qkv[..., :c])
    k = heads(qkv[..., c:2 * c])[:, :, :n_valid]
    v = heads(qkv[..., 2 * c:])[:, :, :n_valid]
    out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return out.transpose(1, 2).reshape(b, s, c)


def check_v3(qkv: torch.Tensor, *, scale: float, num_heads: int,
             n_valid: int) -> dict:
    """Hold K2's bf16-score instantiation against the plain v3 on ``qkv``
    (see the module docstring); raises where it fails.  Mean errors are
    over every output element; the max error must also stay within the
    bf16 bound of the plain v3."""
    kw = dict(scale=scale, num_heads=num_heads, n_valid=n_valid)
    want = masked_attention_packed_plain(qkv, score_dtype=torch.bfloat16,
                                         **kw).float()
    mean_err = lambda got: (got.float() - want).abs().mean().item()
    gap = mean_err(masked_attention_packed_plain(qkv, **kw))
    got = masked_flash_attention_packed(qkv, score_dtype=torch.bfloat16,
                                        **kw)
    err, tol = bf16_error(got, want)
    out = {"max_abs_err": err, "bound": tol, "mean_err": mean_err(got),
           "v0_mean_gap": gap,
           "k2_mean_err": mean_err(masked_flash_attention_packed(qkv, **kw))}
    if err > tol or out["mean_err"] > V3_SHARE * gap:
        raise AssertionError(f"v3: the bf16-score kernel is not v3: {out}")
    if out["k2_mean_err"] <= V3_SHARE * gap:
        raise AssertionError(f"v3: the inputs do not tell K2 from v3: {out}")
    return out


def run(reps: int = 20, b: int = B, s: int = S, nh: int = NH, hd: int = HD,
        n_valid: int = N_VALID) -> dict:
    """Each variant's kernel against its plain version, its time and its
    ``max|Δ vs v0|``; the plain versions' and SDPA's times; then v3's
    check at large logits."""
    dev = require_cuda()
    x = qkv_input(b, s, nh * hd)
    qkv = torch.from_numpy(x).to(device=dev, dtype=torch.bfloat16)
    kw = dict(scale=hd ** -0.5, num_heads=nh, n_valid=n_valid)
    _, _, bound_ms, bound_by = kernel_cost(
        "packed_masked_attention", b=b, s=s, nh=nh, hd=hd, n_valid=n_valid)
    log(f"packed attention ({b}, {s}, {3 * nh * hd}) bf16, {nh} x {hd}, "
        f"n_valid {n_valid}: bound {bound_ms:.4f} ms ({bound_by})")
    out = {"bound_ms": bound_ms, "bound_by": bound_by}
    ref = None
    for name, score_dtype in VARIANTS.items():
        kernel = lambda: masked_flash_attention_packed(
            qkv, score_dtype=score_dtype, **kw)
        plain = lambda: masked_attention_packed_plain(
            qkv, score_dtype=score_dtype, **kw)
        got = kernel()
        err, tol = bf16_error(got, plain())
        if err > tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err} > {tol})")
        valid = got[:, :n_valid].float()
        if ref is None:
            ref = valid
        delta = (valid - ref).abs().max().item()
        t = device_ms(kernel, reps=reps)
        tp = device_ms(plain, reps=2, runs=3)
        out[name] = {"ms": t.median_ms, "spread_ms": t.spread_ms,
                     "plain_ms": tp.median_ms, "max_abs_err": err,
                     "max_delta_vs_v0": delta}
        log(f"{name}: {t}, plain {tp}, max|delta vs v0|={delta:.2e}, "
            f"max_abs_err vs plain {err:.2e} (bound {tol:.2e}), "
            f"{100 * bound_ms / t.median_ms:.1f}% of the bound")
    lib = sdpa(qkv, **kw)
    err, _ = bf16_error(lib, masked_attention_packed_plain(qkv, **kw))
    t = device_ms(lambda: sdpa(qkv, **kw), reps=reps)
    out["library_ms"] = t.median_ms
    log(f"SDPA on {n_valid} keys (library yardstick): {t}, max_abs_err vs "
        f"plain {err:.2e}")
    del qkv
    big = torch.from_numpy(x * LOGIT_SCALE).to(device=dev,
                                               dtype=torch.bfloat16)
    out["v3_check"] = v3 = check_v3(big, **kw)
    log(f"v3 at logits x {LOGIT_SCALE:g}: max_abs_err {v3['max_abs_err']:.2e}"
        f" (bound {v3['bound']:.2e}); mean |kernel - plain v3| "
        f"{v3['mean_err']:.2e}, mean |plain v0 - plain v3| "
        f"{v3['v0_mean_gap']:.2e} (limit {V3_SHARE:g} x), mean |K2 - plain "
        f"v3| {v3['k2_mean_err']:.2e}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
