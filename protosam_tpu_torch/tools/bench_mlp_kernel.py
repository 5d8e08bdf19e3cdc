"""The fused MLP, kernel K7, at the ViT-H layer geometry on the card: the
counterpart of ``tools/bench_mlp_kernel.py``.

K7 at M = 32768 rows (8 images × 64²), C = 1280, H = 5120, bf16, with the
JAX tool's seeded inputs (``bench_mlp_kernel.py:28-34``; the weights, drawn
as (in, out) there, transposed once into the ``nn.Linear`` layout),
against the cuBLAS composition ``res + (gelu_tanh(x w1ᵀ + b1) w2ᵀ + b2)``
(the JAX tool's XLA composition, ``:51-53``) and its f32 plain version.
K7's row tile is fixed when it is compiled (16 rows a block), so the JAX
tool's ``block_m`` / ``h_chunks`` sweep has no counterpart.  K7 is also
timed with the L2 cache flushed before every launch: back to back, its
26 MB of weights stay in the 50 MB L2, while in the encoder every block
brings its own weights from device memory.

    python3 -m protosam_tpu_torch.tools.bench_mlp_kernel [--reps 5]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from protosam_tpu_torch.ops.mlp import mlp_fused, mlp_fused_plain
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import (bf16_error, device_ms, log,
                                             require_cuda)

M, C, H = 32768, 1280, 5120


def run(reps: int = 5, m: int = M, c: int = C, h: int = H) -> dict:
    dev = require_cuda()
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=dev, dtype=torch.bfloat16)
    x = t(rng.standard_normal((m, c)) * 0.5)
    w1 = t(rng.standard_normal((c, h)).T * 0.02)
    b1 = t(rng.standard_normal((h,)) * 0.02)
    w2 = t(rng.standard_normal((h, c)).T * 0.02)
    b2 = t(rng.standard_normal((c,)) * 0.02)
    res = t(rng.standard_normal((m, c)) * 0.5)
    args = (x, w1, b1, w2, b2, res)
    err, tol = bf16_error(mlp_fused(*args), mlp_fused_plain(*args))
    if err > tol:
        raise AssertionError(f"K7: {err} > {tol}")
    flops, _, bound_ms, bound_by = kernel_cost("mlp_fused", m=m, c=c, h=h)
    log(f"MLP ({m}, {c}) -> {h} -> {c} bf16 + residual: "
        f"{flops / 1e9:.1f} GFLOP, bound {bound_ms:.4f} ms ({bound_by}); "
        f"K7 max_abs_err vs plain {err:.3e} (bound {tol:.3e})")
    timed = {
        "kernel": lambda: mlp_fused(*args),
        "cublas composition": lambda: res + F.linear(
            F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2),
        "plain f32": lambda: mlp_fused_plain(*args),
    }
    out = {"bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
    for label, fn in timed.items():
        tm = device_ms(fn, reps=reps, runs=3)
        out[label] = tm.median_ms
        log(f"{label}: {tm} = {flops / tm.median_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound_ms / tm.median_ms:.1f}% of the bound")
    tm = device_ms(timed["kernel"], reps=reps, runs=3, l2_flush=True)
    out["kernel, L2 flushed"] = tm.median_ms
    log(f"kernel, L2 flushed before each launch: {tm}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
