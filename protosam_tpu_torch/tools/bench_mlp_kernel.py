"""The fused MLP, kernel K7, at the ViT-H layer geometry on the card: the
counterpart of ``tools/bench_mlp_kernel.py``.

K7 at M = 32768 rows (8 images × 64²), C = 1280, H = 5120, bf16, with the
JAX tool's seeded inputs (``bench_mlp_kernel.py:28-34``; the weights, drawn
as (in, out) there, transposed once into the ``nn.Linear`` layout),
against the cuBLAS composition ``res + (gelu_tanh(x w1ᵀ + b1) w2ᵀ + b2)``
(the JAX tool's XLA composition, ``:51-53``) and its f32 plain version.
K7's tiles are fixed when it is compiled (a cluster of eight blocks owns
128 rows, each block an eighth of the output columns, and the cluster walks
the hidden units 512 at a time), so the JAX tool's ``block_m`` /
``h_chunks`` sweep has no counterpart.  K7 is also timed with the L2 cache
flushed before every launch: back to back, its 26 MB of weights stay in
the 50 MB L2, while in the encoder each layer's weights come from device
memory.

``check_exchange`` holds K7's exchange of hidden chunks between the blocks
of a cluster: each block's 64-unit chunk of every 512-unit step gets its
own scale (W1 rows and the matching W2 columns times 1, 2, 4, 8, 1.5, 3, 6
and 12), so a chunk read from the wrong peer moves the output far past the
bf16 bound.  Its control, the plain version with two peers' chunks
swapped, must fail that bound.

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
# K7's cluster (csrc/mlp_fused.cu kCluster, kChunk): eight blocks, each
# computes 64 hidden units of every step and shares them with its peers
CLUSTER, CHUNK = 8, 64
EXCHANGE_SCALES = (1.0, 2.0, 4.0, 8.0, 1.5, 3.0, 6.0, 12.0)
SWAPPED_PEERS = (3, 7)


def _peer(h: int) -> torch.Tensor:
    """The block of the cluster that computes each of ``h`` hidden units."""
    return (torch.arange(h) // CHUNK) % CLUSTER


def exchange_scaled(w1: torch.Tensor, w2: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """W1 rows and the matching W2 columns times the scale of the peer that
    computes them."""
    sc = torch.tensor(EXCHANGE_SCALES)[_peer(w1.shape[0])].to(w1.device)
    return ((w1.float() * sc[:, None]).to(w1.dtype),
            (w2.float() * sc[None, :]).to(w2.dtype))


def swap_peers(w2: torch.Tensor) -> torch.Tensor:
    """W2 with the columns of two peers' chunks swapped in every step: the
    output of a kernel that took one peer's chunk for the other's."""
    h = w2.shape[1]
    a, b = SWAPPED_PEERS
    perm = torch.arange(h)
    peer = _peer(h)
    perm[peer == a] += (b - a) * CHUNK
    perm[peer == b] -= (b - a) * CHUNK
    # in a ragged last step a chunk whose partner lies past h stays put
    perm = torch.where(perm < h, perm, torch.arange(h))
    return w2[:, perm.to(w2.device)]


def check_exchange(x, w1, b1, w2, b2, res=None) -> dict:
    """Hold K7 against its f32 plain version with each peer's chunk scaled
    by its own factor; raises where it leaves the bf16 bound, or where the
    control (two peers' chunks swapped) does not."""
    w1s, w2s = exchange_scaled(w1, w2)
    want = mlp_fused_plain(x.float(), w1s, b1, w2s, b2, res)
    got = mlp_fused(x, w1s, b1, w2s, b2, res)
    control = mlp_fused_plain(x.float(), w1s, b1, swap_peers(w2s), b2, res)
    err, tol = bf16_error(got, want)
    ctl_err, _ = bf16_error(control, want)
    out = {"max_abs_err": err, "bound": tol, "control_max_err": ctl_err}
    if err > tol:
        raise AssertionError(f"K7 mixes up the exchanged chunks: {out}")
    if ctl_err <= tol:
        raise AssertionError(f"the swapped-chunk control passes the bf16 "
                             f"bound: the inputs cannot tell: {out}")
    return out


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
    chk = check_exchange(*args)
    log(f"check_exchange: max_abs_err {chk['max_abs_err']:.3e} (bound "
        f"{chk['bound']:.3e}), control with peers {SWAPPED_PEERS} swapped "
        f"{chk['control_max_err']:.3e}")
    out = {"bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
           "exchange_check": chk}
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
