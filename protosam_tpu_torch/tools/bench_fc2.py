"""The ViT-H fc2 GEMM with its bias and residual on the card: the
counterpart of ``tools/bench_fc2.py``, whose ``pallas_fc2`` (:90) is a
blocked bf16 GEMM with an f32 accumulator and a bias-plus-residual
epilogue rounded once.

That is exactly what kernel K6 ``dense_residual`` computes, so this tool
launches K6 at the fc2 geometry (M = 39200 = 8 × 70 × 70 padded tokens,
K = 5120, N = 1280, bf16) with the JAX tool's seeded inputs
(``bench_fc2.py:117-122``); the weight, drawn as (K, N) there, is
transposed once, outside the timing, into the ``nn.Linear`` layout (N, K)
that K6 takes.  K6 masks the ragged M itself, so M is not padded.  Beside
it: the cuBLAS composition ``torch.addmm(b, x, wᵀ) + r`` (the counterpart of
the XLA dense + bias + residual baseline) and the f32 plain version.

The JAX tool's sweep of XLA compiler options (``:131-162``) tunes the TPU
compiler and has no counterpart here.

    python3 -m protosam_tpu_torch.tools.bench_fc2 [--reps 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from protosam_tpu_torch.ops.mlp import dense_residual, dense_residual_plain
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import (bf16_error, device_ms, log,
                                             require_cuda)

M, K, N = 39200, 5120, 1280  # vit_h fc2 at batch 8, 70x70 padded tokens


def fc2_inputs(m: int = M, k: int = K, n: int = N, seed: int = 0
               ) -> tuple[np.ndarray, ...]:
    """The JAX tool's inputs as float64 numpy: x (m, k), w (k, n), b (1, n),
    r (m, n), drawn in that order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * 0.1
    w = rng.standard_normal((k, n)) * 0.02
    b = rng.standard_normal((1, n)) * 0.01
    r = rng.standard_normal((m, n)) * 0.1
    return x, w, b, r


def to_kernel_layout(x, w, b, r, device, dtype=torch.bfloat16):
    """Tensors in the layout K6 takes: w transposed to (N, K), b (N,)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    return t(x), t(w.T), t(b[0]), t(r)


def run(reps: int = 10, m: int = M, k: int = K, n: int = N) -> dict:
    """Check K6 against the f32 plain version, then time K6, the cuBLAS
    composition and the plain version; returns the numbers."""
    dev = require_cuda()
    x, w, b, r = to_kernel_layout(*fc2_inputs(m, k, n), dev)
    err, bound = bf16_error(dense_residual(x, w, b, r),
                            dense_residual_plain(x.float(), w, b, r))
    if err > bound:
        raise AssertionError(f"K6 at the fc2 geometry disagrees with its "
                             f"plain version: {err} > {bound}")
    flops, _, bound_ms, bound_by = kernel_cost("dense_residual", m=m, k=k,
                                               n=n)
    out = {"max_abs_err": err, "err_bound": bound, "bound_ms": bound_ms,
           "bound_by": bound_by}
    timed = {
        "kernel": lambda: dense_residual(x, w, b, r),
        "cublas addmm + r": lambda: torch.addmm(b, x, w.T) + r,
        "plain f32": lambda: dense_residual_plain(x, w, b, r),
    }
    log(f"fc2 M={m} K={k} N={n} bf16: {flops / 1e9:.1f} GFLOP, bound "
        f"{bound_ms:.4f} ms ({bound_by}); K6 vs plain max_abs_err "
        f"{err:.3e} (bound {bound:.3e})")
    for label, fn in timed.items():
        t = device_ms(fn, reps=reps)
        out[label] = t.median_ms
        out[label + " spread"] = t.spread_ms
        log(f"fc2 {label}: {t} = {flops / t.median_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound_ms / t.median_ms:.1f}% of the bound")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
