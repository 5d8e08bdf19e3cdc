"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles the hand-written kernels (csrc/) and prints the seconds;
2. kernels: each kernel against its plain PyTorch version at the flagship
   shapes (B = 2 slices), with the error and median times of both;
3. wiring: the tiny pipeline (dinov2_t14 at 126 px + SAM vit_t at 256) on
   the card with kernels against the same weights and inputs on the CPU;
4. flagship: DINOv2-L/14 at 672 px + SAM ViT-B at 1024, bf16 with the f32
   tails, ``forward_volume`` over 8 smooth synthetic slices, twice; every
   kernel must have launched on that path.

Then one JSON line with the kernels' numbers and, last, the result line.
Imports only torch, numpy and protosam_tpu_torch.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BF16_TOL = 2e-2          # x max(1, max|ref|), against the f32 plain version
F32_TOL = 1e-4
B = 2                    # slices per kernel check


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, the bf16 bound max(1, max|want|) x BF16_TOL)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs().max().item()
    return err, BF16_TOL * max(1.0, want.abs().max().item())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 0 device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> None:
    from protosam_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s -> {lib.name}")


def _check(name, kernel_fn, plain_fn, ref_fn, tol_kind, entries, **meta):
    """Run the kernel once against the f32 plain version, then time the
    kernel and the plain version on the same inputs."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = ref_fn()
    if tol_kind == "exact":
        err = float((got.long() - want.long()).abs().max().item())
        ok, bound = torch.equal(got, want), 0.0
    else:
        err, bound = max_err(got, want)
        if tol_kind == "f32":
            bound = F32_TOL
        ok = err <= bound
    ms = median_ms(kernel_fn)
    plain_ms = median_ms(plain_fn)
    log(f"phase 2 kernel {name}: max_abs_err {err:.3e} (bound {bound:.3e}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {bound})")
    entries.append(dict(name=name, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, **meta))


def _cca_masks(h: int, w: int, seed: int) -> torch.Tensor:
    """Random blobs, a snake, white noise, an empty and a full mask."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    blobs = np.zeros((h, w), bool)
    for _ in range(12):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(h // 40, h // 8)
        blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    snake = np.zeros((h, w), bool)
    for r in range(0, h, 4):
        snake[r, :] = True
        col = w - 1 if (r // 4) % 2 == 0 else 0
        snake[r:r + 5, col] = True
    noise = rng.random((h, w)) > 0.5
    masks = np.stack([blobs, snake, noise, np.zeros((h, w), bool),
                      np.ones((h, w), bool)])
    return torch.from_numpy(masks.astype(np.uint8))


def phase_kernels() -> list[dict]:
    from protosam_tpu_torch.ops.attention import (
        masked_attention_packed_plain, masked_flash_attention_packed)
    from protosam_tpu_torch.ops.cca import (label_components,
                                            label_components_plain)
    from protosam_tpu_torch.ops.norm import (layer_norm_rows,
                                             layer_norm_rows_plain)
    from protosam_tpu_torch.ops.vitdet_flash import (
        relpos_patch_attention, relpos_patch_attention_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g).to(dev)
    entries: list[dict] = []

    # K1: every block LayerNorm of DINOv2-L (B*2432, 1024) and SAM-B
    # (B*4096, 768); bf16 is the production type, f32 the parity type
    for rows, c in ((B * 2432, 1024), (B * 4096, 768)):
        x = randn(rows, c) * 3 + 1
        wt, bs = 1 + 0.1 * randn(c), 0.1 * randn(c)
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            xd = x.to(dt)
            _check(f"layer_norm_rows ({rows}x{c} {kind})",
                   lambda: layer_norm_rows(xd, wt, bs, 1e-6),
                   lambda: layer_norm_rows_plain(xd, wt, bs, 1e-6, dt),
                   lambda: layer_norm_rows_plain(xd.float(), wt, bs, 1e-6,
                                                 torch.float32),
                   kind, entries, kernel="layer_norm_rows")

    # K2: DINOv2-L at 672 px: 2305 tokens padded to 2432, 16 heads x 64
    qkv = randn(B, 2432, 3 * 1024).to(torch.bfloat16)
    kw = dict(scale=0.125, num_heads=16, n_valid=2305)
    _check("packed_masked_attention (2x2432x3072 bf16, n_valid 2305)",
           lambda: masked_flash_attention_packed(qkv, **kw),
           lambda: masked_attention_packed_plain(qkv, **kw),
           lambda: masked_attention_packed_plain(qkv.float(), **kw),
           "bf16", entries, kernel="packed_masked_attention")

    # K4: SAM ViT-B windowed (70x70 padded grid, P=14) and global (64x64)
    for name, side, patch in (("window", 70, 14), ("global", 64, 64)):
        qkv = randn(B, side, side, 3 * 768).to(torch.bfloat16)
        bias = (0.5 * randn(B, side, side, 12 * 2 * patch)).to(torch.bfloat16)
        _check(f"relpos_patch_attention {name} ({side}x{side}, P={patch})",
               lambda: relpos_patch_attention(qkv, bias, patch, 12, 0.125),
               lambda: relpos_patch_attention_plain(qkv, bias, patch, 12,
                                                    0.125),
               lambda: relpos_patch_attention_plain(qkv.float(), bias.float(),
                                                    patch, 12, 0.125),
               "bf16", entries, kernel="relpos_patch_attention",
               geometry=name)

    # K3: five 1024^2 masks of different shape classes, exact equality
    masks = _cca_masks(1024, 1024, seed=0).to(dev)
    _check("cca_label (5x1024x1024: blobs, snake, noise, empty, full)",
           lambda: label_components(masks),
           lambda: label_components_plain(masks),
           lambda: label_components_plain(masks),
           "exact", entries, kernel="cca_label")
    return entries


def smooth_volume(n: int, size: int, seed: int) -> torch.Tensor:
    """Low-frequency slices (random 21² fields upsampled, ×3), the bench.py
    recipe: anatomy-like structure instead of white noise."""
    from protosam_tpu_torch.ops.resize import resize_bilinear

    g = torch.Generator().manual_seed(seed)
    return resize_bilinear(torch.randn(n, 3, 21, 21, generator=g),
                           (size, size)) * 3.0


def _episode(size: int, device, seed: int):
    from protosam_tpu_torch.models.io_protocol import ALPNetInput

    g = torch.Generator().manual_seed(seed)
    supp = torch.randn(1, 3, size, size, generator=g)
    fg = torch.zeros(1, size, size)
    q = size // 3
    fg[:, q:2 * q, q:2 * q] = 1.0
    return ALPNetInput(supp, fg, supp).to(device)


def dice(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a > 0.5, b > 0.5
    den = (a.sum() + b.sum()).item()
    return 1.0 if den == 0 else 2.0 * (a & b).sum().item() / den


def phase_wiring() -> None:
    """The tiny pipeline in f32 on the card (kernels) and on the CPU (plain
    versions), same seeded weights and inputs."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig

    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                              image_size=126, sam_size=256,
                              dtype=torch.float32, seed=3,
                              config=ProtoSAMConfig(image_size=(256, 256),
                                                    max_ccs=4))
        vol = smooth_volume(4, 126, seed=4).to(dev)
        preds, scores = pipe.forward_volume(vol, _episode(126, dev, 5),
                                            slice_batch=2)
        outs[dev] = (preds.cpu(), scores.cpu())
    dices = [dice(a, b) for a, b in zip(outs["cuda"][0], outs["cpu"][0])]
    score_err = (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()
    mean = sum(dices) / len(dices)
    log(f"phase 3 wiring: tiny pipeline card vs CPU mean Dice {mean:.5f} "
        f"(per slice {[round(d, 5) for d in dices]}), max score diff "
        f"{score_err:.2e}, card fg share {outs['cuda'][0].mean().item():.4f}")
    if mean < 0.99:
        raise AssertionError(f"card/CPU Dice {mean} < 0.99")


def phase_flagship(wrappers: dict) -> dict:
    """Flagship forward_volume over 8 slices at slice_batch 4, twice."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.ops.cca import connected_components

    t0 = time.perf_counter()
    pipe = build_pipeline("cuda")
    torch.cuda.synchronize()
    log(f"phase 4 flagship: built DINOv2-L/14 672 + SAM ViT-B bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    n, batch = 8, 4
    vol = smooth_volume(n, 672, seed=6).cuda()
    inp = _episode(672, "cuda", 7)

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    preds, scores = pipe.forward_volume(vol, inp, slice_batch=batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    t0 = time.perf_counter()
    preds2, scores2 = pipe.forward_volume(vol, inp, slice_batch=batch)
    torch.cuda.synchronize()
    second = time.perf_counter() - t0

    if preds.shape != (n, 672, 672) or scores.shape[0] != n:
        raise AssertionError(f"shapes {preds.shape} {scores.shape}")
    if not torch.isfinite(scores).all():
        raise AssertionError("non-finite scores")
    if not torch.equal(preds, preds2) or not torch.equal(scores, scores2):
        raise AssertionError("second run differs: labels not deterministic")
    ccs = connected_components(preds, max_ccs=8).num.tolist()
    fg = preds.float().mean(dim=(1, 2)).tolist()
    log(f"phase 4 flagship: fg share per slice {[round(f, 4) for f in fg]}; "
        f"components per slice {ccs}; scores {scores[:, 0].tolist()}")
    log(f"phase 4 flagship: kernel launches {launches}")
    log(f"phase 4 flagship: wall {first / n * 1e3:.1f} ms/slice first run, "
        f"{second / n * 1e3:.1f} ms/slice second run ({n} slices, "
        f"slice_batch {batch}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return launches


_REPLACES = {
    "layer_norm_rows": ("protosam_tpu_torch/csrc/layer_norm.cu",
                        "protosam_tpu/ops/norm.py:86"),
    "packed_masked_attention": ("protosam_tpu_torch/csrc/attention.cu",
                                "protosam_tpu/ops/attention.py:161"),
    "relpos_patch_attention": ("protosam_tpu_torch/csrc/attention.cu",
                               "protosam_tpu/ops/vitdet_flash.py:478"),
    "cca_label": ("protosam_tpu_torch/csrc/cca.cu",
                  "protosam_tpu/ops/cca_pallas.py:171"),
}


def kernel_report(checks: list[dict], launches: dict) -> dict:
    """One entry per kernel: the production-type check at the flagship
    shape (K1: the DINOv2 bf16 rows; K4: the window geometry, with the
    global geometry's numbers under ``global_*``)."""
    out = []
    for name, (src, replaces) in _REPLACES.items():
        rows = [c for c in checks if c["kernel"] == name]
        main = rows[0]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 "ms": main["ms"], "plain_ms": main["plain_ms"]}
        if name == "relpos_patch_attention":
            glob = next(r for r in rows if r.get("geometry") == "global")
            entry.update(also_replaces="protosam_tpu/ops/vitdet_flash.py:264",
                         global_ms=glob["ms"],
                         global_plain_ms=glob["plain_ms"])
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    from protosam_tpu_torch.ops.attention import masked_flash_attention_packed
    from protosam_tpu_torch.ops.cca import label_components
    from protosam_tpu_torch.ops.norm import layer_norm_rows
    from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention

    wrappers = {"layer_norm_rows": layer_norm_rows,
                "packed_masked_attention": masked_flash_attention_packed,
                "relpos_patch_attention": relpos_patch_attention,
                "cca_label": label_components}
    phase_device()
    phase_build()
    checks = phase_kernels()
    phase_wiring()
    launches = phase_flagship(wrappers)
    log(json.dumps(kernel_report(checks, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
