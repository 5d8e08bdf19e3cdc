"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles the hand-written kernels (csrc/) and prints the seconds;
2. kernels: each kernel against its plain PyTorch version at the shapes
   of the flagship and of the ViT-H configuration (B = 2 slices, from
   ``tools.roofline.MAIN_PATH_SHAPES``), with the error and the device
   times (``tools.timing.device_ms``) of both and of the library call;
   K2 is held to its plain version with the keys past n_valid 8 times
   larger, where an unmasked control must fail
   (``tools.bench_dino_flash.check_mask``), its bf16-score instantiation to
   the plain v3 at large logits (``tools.microbench_attn.check_v3``), and K4
   to its plain version at scores spread ~4 in all four geometries, where a
   swapped-bias control must fail (``tools.bench_attn.check_bias``); K7
   with each peer block's hidden chunk scaled by its own factor,
   where a control with two peers' chunks swapped must fail
   (``tools.bench_mlp_kernel.check_exchange``); K3 also on masks whose
   components cross its tiles only at their corners or along a diagonal
   (untimed); K3, K5 and K6 run twice must give the same bits; K8
   ``quantize_rows`` (codes and scale bits; one operand, and both operands
   of DINOv2-L fc2 in the one launch a layer makes,
   ``quantize_operands``) and K9 ``int8_dense`` are held bit-equal to
   their plain versions at the int8 flagship's shapes (DINOv2-L qkv, fc1
   and fc2, SAM ViT-B qkv and fc2, activations and weights) and a ragged
   one, and rerun bit-identical;
3. wiring: the tiny pipeline (dinov2_t14 at 126 px + SAM vit_t at 256) on
   the card with kernels against the same weights and inputs on the CPU,
   once as built by default and once with the fused ALP match (K5);
4. flagship: DINOv2-L/14 at 672 px + SAM ViT-B at 1024, bf16 with the f32
   tails, ``forward_volume`` over 8 smooth synthetic slices, twice; K1-K4
   must have launched on that path;
4b. flagship int8: the same pipeline with both encoders' dense stages on
   the int8 W8A8 path (``build_pipeline(quant_dense=True)``, the JAX entry
   point's default), the same weights and slices; K8 and K9 must have
   launched, equally often (one K8 launch a layer), and K6 and K7 must
   not; its masks must agree with phase 4's (mean Dice >= 0.99, the min
   printed); its wall time is printed beside phase 4's; then the same
   build with the fused MLP and projection routes requested runs one batch,
   where K6 and K7 must still not launch and the masks must agree with the
   first build's;
5. ViT-H: the eval configuration with SAM ViT-H and the fused ALP, MLP and
   projection routes, built by ``eval.protosam_eval.build_models``
   (``tools.pipeline_profile.build_config``),
   ``forward_volume`` over the same kind of slices, twice; all seven
   kernels must have launched, and its masks must agree (mean Dice >= 0.99)
   with the same weights built with the three fused routes off;
6. tools: the measurement tools' own entry functions at small rep counts:
   ``bench_fc2`` (K6 at the ViT-H fc2 geometry, row 13 of the kernel
   table) and ``microbench_attn`` (K2 and its bf16-score variant, row 14)
   must launch their kernels; ``trace_volume`` on the flagship prints the
   device idle share and the top five kernels;
7. eval: the evaluation entry point on a CHAOS-T2-like NIfTI fold (20
   scans of 30 x 256² slices) written with the port's ``write_nii``, with
   ``run_protosam.sh mri``'s settings (DINOv2-L/14 at 672, bf16): 7a
   ProtoSAM with SAM ViT-B and 7b ProtoMedSAM, each ``run_eval`` built in
   memory from the seed and from ``.pth`` snapshots of the same weights
   (an ALPNet snapshot and a SAM ViT-B state_dict), whose masks must be
   bit-equal, with K1-K4 launched in every run; 7a's ``per_slice`` mode
   must agree with ``volume`` (metrics within 1e-3, mask Dice >= 0.99);
   ``run_eval``'s slices/s is printed beside ``forward_volume``'s
   ms/slice; 7c holds the rotate / reverse ops (1e-5) and the tiny
   pipeline's ``forward(degrees_rotate=15)`` (Dice >= 0.99, scores 1e-4)
   on the card to the CPU.

Then one JSON line with the kernels' numbers (each with its bound from
``tools.roofline.kernel_cost`` and, where one PyTorch call computes the
same function, that call's time as ``library_ms``) and, last, the result
line.  Imports only torch, numpy and protosam_tpu_torch.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BF16_TOL = 2e-2          # x max(1, max|ref|), against the f32 plain version
F32_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _check(name, kernel_fn, plain_fn, ref_fn, tol_kind, entries, cost,
           library=None, compare=None, **meta):
    """Run the kernel once against the f32 plain version, then time the
    kernel, the plain version and, where there is one, the one library call
    that computes the same function, on the same inputs: per-launch device
    ms, the median of 5 runs of 10 back-to-back launches (the plain
    version: 3 runs of 2).  ``cost`` is the (kernel, shapes) pair that
    ``kernel_cost`` bounds; ``compare`` maps an output to the tensor that
    is checked (K8 returns codes and scales)."""
    from protosam_tpu_torch.tools.roofline import kernel_cost
    from protosam_tpu_torch.tools.timing import bf16_error, device_ms

    compare = compare or (lambda out: out)
    got = compare(kernel_fn())
    torch.cuda.synchronize()
    want = compare(ref_fn())
    if tol_kind == "exact":
        err = float((got.long() - want.long()).abs().max().item())
        ok, bound = torch.equal(got, want), 0.0
    else:
        err, bound = bf16_error(got, want, BF16_TOL)
        if tol_kind == "f32":
            bound = F32_TOL
        ok = err <= bound
    ms = device_ms(kernel_fn).median_ms
    plain_ms = device_ms(plain_fn, reps=2, runs=3).median_ms
    library_ms = None if library is None else device_ms(library).median_ms
    _, _, bound_ms, bound_by = kernel_cost(cost[0], **cost[1])
    extra = "".join(f" {k[:-3]} {v:.4f} ms" for k, v in meta.items()
                    if k.endswith("_ms"))
    if library_ms is not None:
        extra += f" library {library_ms:.4f} ms"
    log(f"phase 2 kernel {name}: max_abs_err {err:.3e} (bound {bound:.3e}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{extra}; roofline "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {bound})")
    entries.append(dict(name=name, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, **meta))


def _rerun_identical(name, fn, entries) -> None:
    """``fn`` run twice must give the same bits: nothing may depend on
    timing.  K6 has no atomics and no split sums; K3's atomics may land in
    any order, but every root is its component's minimum index; K5 merges
    its prototype splits in a fixed order, with no atomics."""
    same = torch.equal(fn(), fn())
    entries[-1]["rerun_identical"] = same
    log(f"phase 2 kernel {name}: rerun bit-identical: {same}")
    if not same:
        raise AssertionError(f"{name}: a rerun changed the output")


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


def _cca_tile_classes(side: int) -> torch.Tensor:
    """Checkerboards of periods 16, 32 and 64 whose squares touch only at
    their corners (NW-SE and NE-SW), and a 1-pixel diagonal line each
    way: components that cross K3's 32 x 32 tiles only diagonally."""
    yy, xx = np.mgrid[:side, :side]
    masks = []
    for period in (16, 32, 64):
        a, b = (yy % period) < period // 2, (xx % period) < period // 2
        masks += [a == b, a != b]
    masks += [yy == xx, yy == side - 1 - xx]
    return torch.from_numpy(np.stack(masks).astype(np.uint8))


def phase_kernels() -> list[dict]:
    from protosam_tpu_torch.ops.alp import (alp_match_fused,
                                            alp_match_fused_plain)
    from protosam_tpu_torch.ops.attention import (
        masked_attention_packed_plain, masked_flash_attention_packed)
    from protosam_tpu_torch.ops.cca import (label_components,
                                            label_components_plain)
    from protosam_tpu_torch.ops.mlp import (dense_residual,
                                            dense_residual_plain, mlp_fused,
                                            mlp_fused_plain)
    from protosam_tpu_torch.ops.norm import (layer_norm_rows,
                                             layer_norm_rows_plain)
    from protosam_tpu_torch.ops.quant import (int8_matmul_dequant,
                                              int8_matmul_dequant_plain,
                                              quantize_operands,
                                              quantize_rows,
                                              quantize_rows_plain)
    from protosam_tpu_torch.ops.vitdet_flash import (
        relpos_patch_attention, relpos_patch_attention_plain)
    from protosam_tpu_torch.tools import (bench_dino_flash, bench_fc2,
                                          bench_mlp_kernel, microbench_attn)
    from protosam_tpu_torch.tools.bench_attn import (BIAS_SHARE,
                                                     bias_check_inputs,
                                                     check_bias,
                                                     sdpa_operands,
                                                     sdpa_patches)
    from protosam_tpu_torch.tools.roofline import (MAIN_PATH_SHAPES,
                                                   tool_shapes)
    from protosam_tpu_torch.tools.timing import device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g).to(dev)
    entries: list[dict] = []
    shapes = lambda label: MAIN_PATH_SHAPES[label][1]

    # K1: every block LayerNorm of DINOv2-L, SAM-B and SAM-H; bf16 is the
    # production type, f32 the parity type
    for label in ("K1 DINOv2-L rows", "K1 SAM-B rows", "K1 SAM-H rows"):
        rows, c = shapes(label)["rows"], shapes(label)["c"]
        x = randn(rows, c) * 3 + 1
        wt, bs = 1 + 0.1 * randn(c), 0.1 * randn(c)
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            xd, wd, bd = x.to(dt), wt.to(dt), bs.to(dt)
            _check(f"layer_norm_rows ({rows}x{c} {kind})",
                   lambda: layer_norm_rows(xd, wt, bs, 1e-6),
                   lambda: layer_norm_rows_plain(xd, wt, bs, 1e-6, dt),
                   lambda: layer_norm_rows_plain(xd.float(), wt, bs, 1e-6,
                                                 torch.float32),
                   kind, entries,
                   ("layer_norm_rows",
                    dict(rows=rows, c=c, itemsize=xd.element_size())),
                   library=lambda: F.layer_norm(xd, (c,), wd, bd, 1e-6),
                   kernel="layer_norm_rows")

    # K2: DINOv2-L at 672 px: 2305 tokens padded to 2432, 16 heads x 64
    sh = shapes("K2 DINOv2-L")
    k2_cost = MAIN_PATH_SHAPES["K2 DINOv2-L"]
    qkv = randn(sh["b"], sh["s"], 3 * sh["nh"] * sh["hd"]).to(torch.bfloat16)
    kw = dict(scale=sh["hd"] ** -0.5, num_heads=sh["nh"],
              n_valid=sh["n_valid"])
    geometry = (f"{sh['b']}x{sh['s']}x{3 * sh['nh'] * sh['hd']} bf16, "
                f"n_valid {sh['n_valid']}")
    _check(f"packed_masked_attention ({geometry})",
           lambda: masked_flash_attention_packed(qkv, **kw),
           lambda: masked_attention_packed_plain(qkv, **kw),
           lambda: masked_attention_packed_plain(qkv.float(), **kw),
           "bf16", entries, k2_cost,
           library=lambda: microbench_attn.sdpa(qkv, **kw),
           kernel="packed_masked_attention")
    # the mask, with the keys and values past n_valid 8 times larger,
    # against an unmasked control
    del qkv
    masked = torch.from_numpy(bench_dino_flash.mask_check_inputs(
        sh["b"], sh["s"], sh["nh"], sh["hd"], sh["n_valid"])).to(
        dev, torch.bfloat16)
    chk = bench_dino_flash.check_mask(masked, **kw)
    entries[-1]["mask_check"] = chk
    del masked
    log(f"phase 2 kernel packed_masked_attention check_mask (keys past "
        f"n_valid x {bench_dino_flash.MASK_SCALE:g}): max_abs_err "
        f"{chk['max_abs_err']:.3e} (bound {chk['bound']:.3e}); unmasked "
        f"control {chk['control_max_err']:.3e} fails it")
    # K2's bf16-score instantiation (microbench_attn v3) on the tool's
    # input times LOGIT_SCALE (scores spread ~4), where a kernel that
    # skipped v3's roundings would be told apart
    big = torch.from_numpy(microbench_attn.qkv_input(
        sh["b"], sh["s"], sh["nh"] * sh["hd"])
        * microbench_attn.LOGIT_SCALE).to(device=dev, dtype=torch.bfloat16)
    v3 = microbench_attn.check_v3(big, **kw)
    log(f"phase 2 kernel packed_masked_attention bf16 scores at logits x "
        f"{microbench_attn.LOGIT_SCALE:g}: mean |kernel - plain v3| "
        f"{v3['mean_err']:.3e} <= {microbench_attn.V3_SHARE:g} x mean "
        f"|plain v0 - plain v3| {v3['v0_mean_gap']:.3e}; K2 (f32 scores) "
        f"{v3['k2_mean_err']:.3e} is not")
    plain_v3 = lambda: masked_attention_packed_plain(
        big, score_dtype=torch.bfloat16, **kw)
    _check(f"packed_masked_attention bf16 scores ({geometry}, logits x "
           f"{microbench_attn.LOGIT_SCALE:g})",
           lambda: masked_flash_attention_packed(
               big, score_dtype=torch.bfloat16, **kw),
           plain_v3, plain_v3, "bf16", entries, k2_cost,
           library=lambda: microbench_attn.sdpa(big, **kw),
           kernel="bf16_scores", mean_err=v3["mean_err"],
           v0_mean_gap=v3["v0_mean_gap"], k2_mean_err=v3["k2_mean_err"])
    del big

    # K4: SAM windowed (70x70 padded grid, P=14) and global (64x64) at
    # ViT-B (12 heads x 64) and ViT-H (16 heads x 80)
    for model in ("ViT-B", "ViT-H"):
        for geo in ("window", "global"):
            cost = MAIN_PATH_SHAPES[f"K4 {model} {geo}"]
            sh = cost[1]
            b, side, patch, nh, hd = (sh[k] for k in ("b", "hp", "patch",
                                                      "nh", "hd"))
            qkv = randn(b, side, side, 3 * nh * hd).to(torch.bfloat16)
            bias = (0.5 * randn(b, side, side, nh * 2 * patch)).to(
                torch.bfloat16)
            sc = hd ** -0.5
            # SDPA's operands and the expanded bias mask, built untimed
            ops = sdpa_operands(qkv, bias, patch, nh)
            _check(f"relpos_patch_attention {model} {geo} ({side}x{side}, "
                   f"P={patch}, {nh}x{hd})",
                   lambda: relpos_patch_attention(qkv, bias, patch, nh, sc),
                   lambda: relpos_patch_attention_plain(qkv, bias, patch, nh,
                                                        sc),
                   lambda: relpos_patch_attention_plain(
                       qkv.float(), bias.float(), patch, nh, sc),
                   "bf16", entries, cost,
                   library=lambda: sdpa_patches(*ops, sc, b, side, patch),
                   kernel="relpos_patch_attention", geometry=geo,
                   model=model)
            del ops
            # the bias at scores spread ~4, against a swapped-bias control
            big = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in
                   bias_check_inputs(b, side, patch, nh, hd))
            chk = check_bias(*big, patch, nh, sc)
            entries[-1]["bias_check"] = chk
            log(f"phase 2 kernel relpos_patch_attention {model} {geo} "
                f"check_bias at scores spread ~4: mean |kernel - plain| "
                f"{chk['mean_err']:.3e} <= {BIAS_SHARE:g} x mean |plain - "
                f"plain with bias_h, bias_w swapped| "
                f"{chk['swap_mean_gap']:.3e}; max {chk['max_abs_err']:.3e} "
                f"(bound {chk['bound']:.3e}), swapped control max "
                f"{chk['swap_max_err']:.3e} fails it")

    # K3: 1024^2 masks of five shape classes, exact equality
    cost = MAIN_PATH_SHAPES["K3 five 1024^2 masks"]
    masks = _cca_masks(cost[1]["h"], cost[1]["w"], seed=0).to(dev)
    _check(f"cca_label ({'x'.join(map(str, masks.shape))}: blobs, snake, "
           f"noise, empty, full)",
           lambda: label_components(masks),
           lambda: label_components_plain(masks),
           lambda: label_components_plain(masks),
           "exact", entries, cost, kernel="cca_label")
    _rerun_identical("cca_label", lambda: label_components(masks), entries)
    # untimed: the tile-corner and diagonal classes
    corners = _cca_tile_classes(cost[1]["h"]).to(dev)
    same = torch.equal(label_components(corners),
                       label_components_plain(corners))
    entries[-1]["tile_class_equal"] = same
    log(f"phase 2 kernel cca_label tile corners and diagonals "
        f"({'x'.join(map(str, corners.shape))}): equal to the plain "
        f"version: {same}")
    if not same:
        raise AssertionError("cca_label: tile-corner labels differ from the "
                             "plain version's")
    del masks, corners

    # K5: the flagship ALP match, N = 4 slices of 48x48 DINOv2-L features;
    # P = 576 (BG gridconv) and 577 (FG gridconv+) at val_wsize 2, about a
    # quarter of the grid prototypes invalid
    for label in ("K5 P = 576", "K5 P = 577"):
        cost = MAIN_PATH_SHAPES[label]
        n, c, hw, p = (cost[1][k] for k in ("n", "c", "hw", "p"))
        side = int(hw ** 0.5)
        q = randn(n, c, side, side)
        protos = randn(p, c)
        valid = torch.rand(p, generator=g).to(dev) > 0.25
        _check(f"alp_match ({n}x{c}x{side}x{side} f32, P={p})",
               lambda: alp_match_fused(q, protos, valid),
               lambda: alp_match_fused_plain(q, protos, valid),
               lambda: alp_match_fused_plain(q, protos, valid),
               "f32", entries, cost, kernel="alp_match")
        _rerun_identical(f"alp_match P={p}",
                         lambda: alp_match_fused(q, protos, valid), entries)

    # K6 / K7: the ViT-H projection (1280 -> 1280) and MLP (1280 -> 5120 ->
    # 1280) with their residuals, bf16; `unfused_ms` is the modules' own
    # unfused bf16 route (cuBLAS products, separate adds)
    bf = lambda *s, sc=1.0: (randn(*s) * sc).to(torch.bfloat16)
    cost = MAIN_PATH_SHAPES["K6 ViT-H proj"]
    m, c = cost[1]["m"], cost[1]["k"]
    x, res, wp, bp = bf(m, c), bf(m, c), bf(c, c, sc=0.03), bf(c, sc=0.1)
    _check(f"dense_residual ({m}x{c} x {c}x{c} bf16)",
           lambda: dense_residual(x, wp, bp, res),
           lambda: dense_residual_plain(x, wp, bp, res),
           lambda: dense_residual_plain(x.float(), wp, bp, res),
           "bf16", entries, cost, kernel="dense_residual",
           unfused_ms=device_ms(lambda: res + F.linear(x, wp, bp)).median_ms)
    _rerun_identical("dense_residual", lambda: dense_residual(x, wp, bp, res),
                     entries)
    cost = MAIN_PATH_SHAPES["K7 ViT-H MLP"]
    hid = cost[1]["h"]
    w1, b1 = bf(hid, c, sc=0.03), bf(hid, sc=0.1)
    w2, b2 = bf(c, hid, sc=0.015), bf(c, sc=0.1)
    _check(f"mlp_fused ({m}x{c} -> {hid} -> {c} bf16, residual)",
           lambda: mlp_fused(x, w1, b1, w2, b2, res),
           lambda: mlp_fused_plain(x, w1, b1, w2, b2, res),
           lambda: mlp_fused_plain(x.float(), w1, b1, w2, b2, res),
           "bf16", entries, cost, kernel="mlp_fused",
           unfused_ms=device_ms(lambda: res + F.linear(F.gelu(
               F.linear(x, w1, b1), approximate="tanh"), w2,
               b2)).median_ms)
    # each peer's hidden chunk scaled by its own factor, against a control
    # with two peers' chunks swapped
    chk = bench_mlp_kernel.check_exchange(x, w1, b1, w2, b2, res)
    entries[-1]["exchange_check"] = chk
    log(f"phase 2 kernel mlp_fused check_exchange (peer chunks x "
        f"{bench_mlp_kernel.EXCHANGE_SCALES}): max_abs_err "
        f"{chk['max_abs_err']:.3e} (bound {chk['bound']:.3e}); control with "
        f"peers {bench_mlp_kernel.SWAPPED_PEERS} swapped "
        f"{chk['control_max_err']:.3e} fails it")
    del x, res, w1, w2

    # K6 at the ViT-H fc2 geometry of tools/bench_fc2.py (row 13): 39200
    # padded tokens, 5120 -> 1280; M is not a multiple of K6's 128-row tile
    mf, kf, nf = bench_fc2.M, bench_fc2.K, bench_fc2.N
    xf, rf = bf(mf, kf, sc=0.1), bf(mf, nf, sc=0.1)
    wf, bfc = bf(nf, kf, sc=0.02), bf(nf, sc=0.01)
    _check(f"dense_residual fc2 ({mf}x{kf} x {kf}x{nf} bf16)",
           lambda: dense_residual(xf, wf, bfc, rf),
           lambda: dense_residual_plain(xf, wf, bfc, rf),
           lambda: dense_residual_plain(xf.float(), wf, bfc, rf),
           "bf16", entries, tool_shapes()["row 13 fc2"], kernel="fc2",
           unfused_ms=device_ms(
               lambda: torch.addmm(bfc, xf, wf.T) + rf).median_ms)
    _rerun_identical("dense_residual fc2",
                     lambda: dense_residual(xf, wf, bfc, rf), entries)
    del xf, rf, wf

    # K8: the int8 flagship's activations (bf16, a scale per token) and
    # weights (f32, a scale per output channel); codes and scale bits equal
    k8_bits = lambda out: torch.cat([out[0].flatten().int(),
                                     out[1].view(torch.int32)])
    for label in ("K8 DINOv2-L fc2 rows", "K8 DINOv2-L fc2 weight",
                  "K8 SAM-B qkv rows", "K8 SAM-B qkv weight", "K8 ragged"):
        cost = MAIN_PATH_SHAPES[label]
        rows, k, itemsize = (cost[1][key] for key in ("rows", "k",
                                                      "itemsize"))
        dt = torch.bfloat16 if itemsize == 2 else torch.float32
        xq = (randn(rows, k) * (0.02 if itemsize == 4 else 2.0)).to(dt)
        xq[1] = 0  # a zero row: codes 0, the clamped scale
        kind = "bf16" if itemsize == 2 else "f32"
        _check(f"quantize_rows ({rows}x{k} {kind})",
               lambda: quantize_rows(xq), lambda: quantize_rows_plain(xq),
               lambda: quantize_rows_plain(xq), "exact", entries, cost,
               compare=k8_bits, kernel="quantize_rows", label=label)
        _rerun_identical(f"quantize_rows {label}",
                         lambda: k8_bits(quantize_rows(xq)), entries)
        del xq
    # K8 as the main path launches it: both operands of DINOv2-L fc2 (bf16
    # activations, f32 weight) in one launch
    label = "K8 DINOv2-L fc2 operands"
    cost = MAIN_PATH_SHAPES[label]
    m, n, k = (cost[1][key] for key in ("m", "n", "k"))
    xq, wq = (randn(m, k) * 2.0).to(torch.bfloat16), randn(n, k) * 0.02
    xq[1], wq[1] = 0, 0
    both_bits = lambda out: torch.cat([k8_bits(out[:2]), k8_bits(out[2:])])
    plain_both = lambda: (*quantize_rows_plain(xq), *quantize_rows_plain(wq))
    _check(f"quantize_operands ({m}x{k} bf16 + {n}x{k} f32, one launch)",
           lambda: quantize_operands(xq, wq), plain_both, plain_both,
           "exact", entries, cost, compare=both_bits, kernel="quantize_rows",
           label=label, operands=True)
    _rerun_identical(f"quantize_operands {label}",
                     lambda: both_bits(quantize_operands(xq, wq)), entries)
    del xq, wq

    # K9: the int8 product with its rank-1 dequant, bias and bf16 cast,
    # bit-equal to the plain version (exact int32 sums through float64);
    # yardsticks: torch._int_mm with the dequant in torch ops, and bf16
    # F.linear of the same shape on cuBLAS
    for label in ("K9 DINOv2-L fc2", "K9 DINOv2-L qkv", "K9 DINOv2-L fc1",
                  "K9 SAM-B qkv", "K9 SAM-B fc2", "K9 ragged"):
        cost = MAIN_PATH_SHAPES[label]
        m, k, n = (cost[1][key] for key in ("m", "k", "n"))
        qa = torch.randint(-127, 128, (m, k), generator=g,
                           dtype=torch.int8).to(dev)
        qb = torch.randint(-127, 128, (n, k), generator=g,
                           dtype=torch.int8).to(dev)
        sx = torch.rand(m, generator=g).to(dev) * 1e-2
        sw = torch.rand(n, generator=g).to(dev) * 1e-3
        bq = randn(n)
        xa, wa, ba = bf(m, k), bf(n, k, sc=0.02), bq.to(torch.bfloat16)
        int_mm = lambda: ((torch._int_mm(qa, qb.T).float() * sx[:, None])
                          * sw + bq).to(torch.bfloat16)
        _check(f"int8_dense ({m}x{k} x {k}x{n} int8, bf16 out)",
               lambda: int8_matmul_dequant(qa, qb, sx, sw, bq,
                                           torch.bfloat16),
               lambda: int8_matmul_dequant_plain(qa, qb, sx, sw, bq,
                                                 torch.bfloat16),
               lambda: int8_matmul_dequant_plain(qa, qb, sx, sw, bq,
                                                 torch.bfloat16),
               "exact", entries, cost, kernel="int8_dense", label=label,
               int_mm_dequant_ms=device_ms(int_mm).median_ms,
               bf16_linear_ms=device_ms(
                   lambda: F.linear(xa, wa, ba)).median_ms)
        _rerun_identical(f"int8_dense {label}", lambda: int8_matmul_dequant(
            qa, qb, sx, sw, bq, torch.bfloat16), entries)
        del qa, qb, xa, wa
    return entries


def dice(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a > 0.5, b > 0.5
    den = (a.sum() + b.sum()).item()
    return 1.0 if den == 0 else 2.0 * (a & b).sum().item() / den


def phase_wiring() -> None:
    """The tiny pipeline in f32 on the card (kernels) and on the CPU (plain
    versions), same seeded weights and inputs; the second leg puts the ALP
    match on K5 (the encoder routes are inert in f32)."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.ops.alp import alp_match_fused
    from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    for fused_alp in (False, True):
        outs = {}
        for dev in ("cuda", "cpu"):
            pipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                                  image_size=126, sam_size=256,
                                  dtype=torch.float32, seed=3,
                                  config=ProtoSAMConfig(
                                      image_size=(256, 256), max_ccs=4),
                                  use_fused_alp=fused_alp)
            vol = smooth_volume(4, 126, seed=4).to(dev)
            before = alp_match_fused.launches
            preds, scores = pipe.forward_volume(
                vol, synthetic_episode(126, dev, 5), slice_batch=2)
            if dev == "cuda" and fused_alp != (alp_match_fused.launches
                                               > before):
                raise AssertionError("K5 launches do not follow "
                                     "use_fused_alp")
            outs[dev] = (preds.cpu(), scores.cpu())
        dices = [dice(a, b) for a, b in zip(outs["cuda"][0], outs["cpu"][0])]
        score_err = (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()
        mean = sum(dices) / len(dices)
        log(f"phase 3 wiring (use_fused_alp={fused_alp}): tiny pipeline card "
            f"vs CPU mean Dice {mean:.5f} (per slice "
            f"{[round(d, 5) for d in dices]}), max score diff "
            f"{score_err:.2e}, card fg share "
            f"{outs['cuda'][0].mean().item():.4f}")
        if mean < 0.99:
            raise AssertionError(f"card/CPU Dice {mean} < 0.99")


N_SLICES, SLICE_BATCH = 8, 4


def zero_counts(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def drive_path(tag: str, pipe, counters: dict, required: list[str],
               seed: int) -> tuple[dict, torch.Tensor, list[float]]:
    """``forward_volume`` over 8 smooth 672² slices at slice_batch 4, twice:
    the counts are zeroed just before the first pass and read just after
    it; the second pass must repeat the first bit for bit.  Returns the
    launch counts, the masks and the two walls in ms/slice."""
    from protosam_tpu_torch.ops.cca import connected_components
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    n, batch = N_SLICES, SLICE_BATCH
    vol = smooth_volume(n, 672, seed=seed).cuda()
    inp = synthetic_episode(672, "cuda", seed + 1)
    torch.cuda.reset_peak_memory_stats()

    zero_counts(counters)
    t0 = time.perf_counter()
    preds, scores = pipe.forward_volume(vol, inp, slice_batch=batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = read_counts(counters)

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
    log(f"{tag}: fg share per slice {[round(f, 4) for f in fg]}; "
        f"components per slice {ccs}; scores {scores[:, 0].tolist()}")
    log(f"{tag}: kernel launches {launches}")
    log(f"{tag}: wall {first / n * 1e3:.1f} ms/slice first run, "
        f"{second / n * 1e3:.1f} ms/slice second run ({n} slices, "
        f"slice_batch {batch}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: "
                             f"{missing}")
    return launches, preds, [first / n * 1e3, second / n * 1e3]


FLAGSHIP_KERNELS = ["layer_norm_rows", "packed_masked_attention",
                    "relpos_patch_attention", "cca_label"]


def phase_flagship(counters: dict) -> tuple[dict, torch.Tensor, list]:
    """The flagship (SAM ViT-B) runs K1-K4."""
    from protosam_tpu_torch.tools.pipeline_profile import build_config

    t0 = time.perf_counter()
    pipe = build_config("flagship", "cuda")
    torch.cuda.synchronize()
    log(f"phase 4 flagship: built DINOv2-L/14 672 + SAM ViT-B bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    return drive_path("phase 4 flagship", pipe, counters, FLAGSHIP_KERNELS,
                      seed=6)


def phase_flagship_int8(counters: dict, bf16_preds: torch.Tensor,
                        bf16_walls: list) -> dict:
    """The flagship with both encoders' dense stages on the int8 path (the
    same seeded weights and slices as phase 4) runs K1-K4, K8 and K9 and
    neither K6 nor K7, and its masks agree with phase 4's bf16 masks at
    mean Dice >= 0.99."""
    from protosam_tpu_torch.tools.pipeline_profile import build_config
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    t0 = time.perf_counter()
    pipe = build_config("flagship_int8", "cuda")
    torch.cuda.synchronize()
    log(f"phase 4b flagship int8: built DINOv2-L/14 672 + SAM ViT-B bf16, "
        f"int8 dense stages, in {time.perf_counter() - t0:.1f} s")
    launches, preds, walls = drive_path(
        "phase 4b flagship int8", pipe, counters,
        FLAGSHIP_KERNELS + ["quantize_rows", "int8_dense"], seed=6)
    # one batch of the same slices, the reference of routes_requested
    batch = (smooth_volume(N_SLICES, 672, seed=6)[:SLICE_BATCH].cuda(),
             synthetic_episode(672, "cuda", 7))
    ref, _ = pipe.forward_volume(*batch, slice_batch=SLICE_BATCH)
    del pipe
    fused = {k: launches[k] for k in ("dense_residual", "mlp_fused")}
    if any(fused.values()):
        raise AssertionError(f"the int8 path launched K6 or K7: {fused}")
    if launches["quantize_rows"] != launches["int8_dense"]:
        raise AssertionError(f"K8 launched {launches['quantize_rows']} "
                             f"times for {launches['int8_dense']} K9 "
                             f"launches: not one a layer")
    routes_requested(counters, batch, ref)
    log(f"phase 4b flagship int8: wall {walls[0]:.1f} / {walls[1]:.1f} "
        f"ms/slice (first / second run) against phase 4's bf16 "
        f"{bf16_walls[0]:.1f} / {bf16_walls[1]:.1f}")
    dices = [dice(a, b) for a, b in zip(preds.cpu(), bf16_preds.cpu())]
    mean = sum(dices) / len(dices)
    log(f"phase 4b flagship int8: masks against phase 4's bf16 masks, same "
        f"weights: mean Dice {mean:.5f}, min {min(dices):.5f} (per slice "
        f"{[round(d, 5) for d in dices]})")
    if mean < 0.99:
        raise AssertionError(f"int8 masks disagree with bf16's: mean Dice "
                             f"{mean} < 0.99")
    return launches


def routes_requested(counters: dict, batch: tuple,
                     ref: torch.Tensor) -> None:
    """The int8 flagship built with the fused MLP and projection routes
    requested: quant turns K6 and K7 off, so one batch of the phase 4b
    slices launches K8 and K9 but neither, and gives the masks ``ref`` of
    the first build on the same batch (the same seeded weights)."""
    from protosam_tpu_torch.entry import build_pipeline

    pipe = build_pipeline("cuda", quant_dense=True, fused_mlp=True,
                          fused_proj=True)
    zero_counts(counters)
    preds, _ = pipe.forward_volume(*batch, slice_batch=SLICE_BATCH)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    del pipe
    log(f"phase 4b flagship int8, fused MLP and projection requested: "
        f"kernel launches {launches}")
    fused = {k: launches[k] for k in ("dense_residual", "mlp_fused")}
    if any(fused.values()) or not (launches["quantize_rows"]
                                   and launches["int8_dense"]):
        raise AssertionError(f"with the fused routes requested the int8 "
                             f"path must launch K8 and K9 and not K6 or "
                             f"K7: {launches}")
    dices = [dice(a, b) for a, b in zip(preds.cpu(), ref.cpu())]
    same = torch.equal(preds.cpu(), ref.cpu())
    log(f"phase 4b flagship int8, fused routes requested: masks against "
        f"the first build's on the same batch: mean Dice "
        f"{sum(dices) / len(dices):.5f}, bit-equal {same}")
    if sum(dices) / len(dices) < 0.99:
        raise AssertionError("the int8 build with the routes requested "
                             "disagrees with the one without")


def phase_vith(counters: dict) -> dict:
    """The eval configuration with SAM ViT-H and all three fused routes
    runs all seven kernels; its masks are held against the same weights
    built with the fused ALP, MLP and projection routes off."""
    from protosam_tpu_torch.tools.pipeline_profile import build_config
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    t0 = time.perf_counter()
    pipe = build_config("vit_h", "cuda")
    torch.cuda.synchronize()
    log(f"phase 5 vit_h: built DINOv2-L/14 672 + SAM ViT-H bf16 (fused ALP, "
        f"MLP, proj) in {time.perf_counter() - t0:.1f} s")
    launches, preds, _ = drive_path("phase 5 vit_h", pipe, counters,
                                    VITH_KERNELS, seed=8)
    del pipe
    plain = build_config("vit_h_unfused", "cuda")
    vol = smooth_volume(N_SLICES, 672, seed=8).cuda()
    inp = synthetic_episode(672, "cuda", 9)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        ref, _ = plain.forward_volume(vol, inp, slice_batch=SLICE_BATCH)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / N_SLICES * 1e3)
    dices = [dice(a, b) for a, b in zip(preds.cpu(), ref.cpu())]
    mean = sum(dices) / len(dices)
    log(f"phase 5 vit_h: routes off (same weights): wall {walls[0]:.1f} "
        f"ms/slice first run, {walls[1]:.1f} ms/slice second run")
    log(f"phase 5 vit_h: fused routes vs routes off, same weights: mean "
        f"Dice {mean:.5f} (per slice {[round(d, 5) for d in dices]})")
    if mean < 0.99:
        raise AssertionError(f"fused/unfused Dice {mean} < 0.99")
    return launches


# the port's kernel -> (its source, the JAX function it replaces); K1-K7
# replace Pallas kernels, K8 and K9 the XLA-fused JAX int8 path
_REPLACES = {
    "layer_norm_rows": ("protosam_tpu_torch/csrc/layer_norm.cu",
                        "protosam_tpu/ops/norm.py:86"),
    "packed_masked_attention": ("protosam_tpu_torch/csrc/packed_attention.cu",
                                "protosam_tpu/ops/attention.py:161"),
    "relpos_patch_attention": ("protosam_tpu_torch/csrc/relpos_attention.cu",
                               "protosam_tpu/ops/vitdet_flash.py:478"),
    "cca_label": ("protosam_tpu_torch/csrc/cca.cu",
                  "protosam_tpu/ops/cca_pallas.py:171"),
    "alp_match": ("protosam_tpu_torch/csrc/alp.cu",
                  "protosam_tpu/ops/alp_pallas.py:30"),
    "dense_residual": ("protosam_tpu_torch/csrc/dense_residual.cu",
                       "protosam_tpu/ops/mlp_pallas.py:88"),
    "mlp_fused": ("protosam_tpu_torch/csrc/mlp_fused.cu",
                  "protosam_tpu/ops/mlp_pallas.py:125"),
    "quantize_rows": ("protosam_tpu_torch/csrc/int8_dense.cu",
                      "protosam_tpu/ops/quant.py:37"),
    "int8_dense": ("protosam_tpu_torch/csrc/int8_dense.cu",
                   "protosam_tpu/ops/quant.py:51"),
}
# the kernels of the ViT-H path (phase 5) and of the int8 flagship (4b)
INT8_KERNELS = ["quantize_rows", "int8_dense"]
VITH_KERNELS = [k for k in _REPLACES if k not in INT8_KERNELS]


# the design of the kernels whose entries name it
_DESIGN = {
    "cca_label": "tile-local union-find in shared memory (32 x 32 tiles), "
                 "a global union on tile borders only, a resolve pass",
    "alp_match": "prototype range split across blocks (128 a split, 64 "
                 "pixels a block, 8 x 8 f32 register tiles, cp.async "
                 "ring), softmax partials merged by a combine pass",
    "quantize_rows": "both operands of a layer in one launch; a team of "
                     "1-8 warps a row held in registers as 16-byte "
                     "vectors (4 or 8 a lane, at most 64 registers a "
                     "thread at 4), amax by shuffles and shared memory, "
                     "__fdiv_rn / __float2int_rn",
    "int8_dense": "persistent warp-specialised s8 wgmma m64n256k32 GEMM, "
                  "128 x 256 tiles on two consumer warpgroups, a loader "
                  "warp keeping a four-stage TMA ring full and staging sw "
                  "and bias in shared memory, rank-1 dequant + bias + cast "
                  "in the epilogue (__fmul_rn, __fadd_rn), stored through "
                  "a per-warp staging tile as whole 128-byte lines",
}


# why a kernel has no one-call PyTorch yardstick (``library_ms`` null):
# "composite" = the library route takes two calls (see ``unfused_ms``),
# "none" = PyTorch has no op for the function
_NO_LIBRARY = {"cca_label": "none", "alp_match": "none",
               "dense_residual": "composite", "mlp_fused": "composite",
               "fc2": "composite", "quantize_rows": "none",
               "int8_dense": "composite"}
# the composite yardsticks: the modules' own unfused route (K6, K7, fc2);
# torch._int_mm with the dequant in torch ops, and bf16 F.linear of the
# same shape (K9)
_YARDSTICKS = ("unfused_ms", "int_mm_dequant_ms", "bf16_linear_ms")


def _numbers(row: dict) -> dict:
    out = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
    if row["library_ms"] is None:
        out["library_note"] = _NO_LIBRARY[row["kernel"]]
    out.update({k: row[k] for k in _YARDSTICKS if k in row})
    return out


def kernel_report(checks: list[dict], launches: dict,
                  flagship_launches: dict, int8_launches: dict,
                  tools: dict, eval_launches: dict) -> dict:
    """One entry per kernel: the production-type check (K1: the DINOv2
    bf16 rows; K4: the ViT-H window geometry, with the ViT-H global
    geometry's numbers under ``global_*``, the flagship's ViT-B window and
    global ones under ``vit_b_*`` and ``vit_b_global_*``, and each
    geometry's ``check_bias`` result; K5: P = 577; K8: the DINOv2-L fc2
    operands in one launch; K9: DINOv2-L fc2; both with every phase-2
    shape's numbers under ``per_shape``).  ``launches`` counts the ViT-H path
    (phase 5), which runs K1-K7, for K1-K7 and the int8 flagship (phase
    4b) for K8 and K9; ``flagship_launches`` the ViT-B flagship (phase 4),
    ``flagship_int8_launches`` the int8 flagship, ``eval_launches``
    ``run_eval`` of phase 7a (``volume``, from the ``.pth`` build).  Rows
    13 and 14 of
    the kernel table take their times from the tools' own runs (phase 6),
    at the tools' shapes, and their launches from those runs.  K2 carries
    its ``check_mask`` result; its f32 and bf16-score instantiations live
    in ``csrc/attention.cu``; K7 its ``check_exchange`` result."""
    out = []
    for name, (src, replaces) in _REPLACES.items():
        rows = [c for c in checks if c["kernel"] == name]
        main = rows[-1] if name == "alp_match" else rows[0]
        if name == "quantize_rows":  # the main path's one launch a layer
            main = next(r for r in rows if r.get("operands"))
        path = int8_launches if name in INT8_KERNELS else launches
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": path[name],
                 "flagship_launches": flagship_launches.get(name, 0),
                 "flagship_int8_launches": int8_launches.get(name, 0),
                 "eval_launches": eval_launches.get(name, 0),
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 **_numbers(main)}
        if name in _DESIGN:
            entry.update(design=_DESIGN[name],
                         rerun_identical=all(r["rerun_identical"]
                                             for r in rows))
        if name in INT8_KERNELS:
            entry.update(per_shape={r["label"]: _numbers(r) for r in rows})
        if name == "cca_label":
            entry.update(tile_class_equal=main["tile_class_equal"])
        if name == "packed_masked_attention":
            entry.update(f32_source="protosam_tpu_torch/csrc/attention.cu",
                         mask_check=main["mask_check"])
        if name == "mlp_fused":
            entry.update(exchange_check=main["exchange_check"])
        if name == "relpos_patch_attention":
            row = lambda m, g: next(r for r in rows if r["model"] == m
                                    and r["geometry"] == g)
            entry.update(
                _numbers(row("ViT-H", "window")),
                f32_source="protosam_tpu_torch/csrc/attention.cu",
                also_replaces="protosam_tpu/ops/vitdet_flash.py:264",
                **{f"{prefix}{k}": v
                   for prefix, m, g in (("global_", "ViT-H", "global"),
                                        ("vit_b_", "ViT-B", "window"),
                                        ("vit_b_global_", "ViT-B", "global"))
                   for k, v in _numbers(row(m, g)).items()},
                bias_check={f"{m} {g}": {k: row(m, g)["bias_check"][k]
                                         for k in ("mean_err",
                                                   "swap_mean_gap",
                                                   "max_abs_err",
                                                   "swap_max_err")}
                            for m in ("ViT-B", "ViT-H")
                            for g in ("window", "global")})
        out.append(entry)

    fc2_check = next(c for c in checks if c["kernel"] == "fc2")
    fc2 = tools["fc2"]
    out.append({"name": "dense_residual fc2 (tools/bench_fc2)",
                "route": "cuda",
                "source": "protosam_tpu_torch/csrc/dense_residual.cu",
                "replaces": "tools/bench_fc2.py:90",
                "launches": tools["fc2_launches"],
                "max_abs_err": max(fc2_check["max_abs_err"],
                                   fc2["max_abs_err"]),
                "ms": fc2["kernel"], "plain_ms": fc2["plain f32"],
                "bound_ms": fc2["bound_ms"], "bound_by": fc2["bound_by"],
                "library_ms": None, "library_note": _NO_LIBRARY["fc2"],
                "unfused_ms": fc2["cublas addmm + r"]})

    v3_b2 = next(c for c in checks if c["kernel"] == "bf16_scores")
    attn = tools["microbench_attn"]
    k2, v3 = attn["v0-v2"], attn["v3"]
    v3_keys = ("mean_err", "v0_mean_gap", "k2_mean_err")
    out.append({"name": "packed_masked_attention v0-v3 "
                        "(tools/microbench_attn)",
                "route": "cuda",
                "source": "protosam_tpu_torch/csrc/packed_attention.cu",
                "v3_source": "protosam_tpu_torch/csrc/attention.cu",
                "replaces": "tools/microbench_attn.py:149",
                "launches": sum(tools["attn_launches"].values()),
                "v3_launches": tools["attn_launches"]["bf16_scores"],
                "max_abs_err": max(k2["max_abs_err"], v3["max_abs_err"]),
                "ms": k2["ms"], "plain_ms": k2["plain_ms"],
                "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
                "library_ms": attn["library_ms"], "v3_ms": v3["ms"],
                "v3_plain_ms": v3["plain_ms"],
                "v3_max_delta_vs_v0": v3["max_delta_vs_v0"],
                # v3 held at logits x LOGIT_SCALE, at B = 8 (phase 6) and
                # B = 2 (phase 2)
                "v3_check": {k: attn["v3_check"][k]
                             for k in ("max_abs_err", *v3_keys)},
                "v3_check_b2": {"max_abs_err": v3_b2["max_abs_err"],
                                **{k: v3_b2[k] for k in v3_keys}}})
    return {"kernels": out}


def phase_tools(counters: dict) -> dict:
    """The tools' own entry functions at small rep counts.  Every count is
    zeroed just before each of the two kernel tools and read just after:
    ``bench_fc2`` must launch K6, ``microbench_attn`` K2 and its bf16-score
    variant.  Then ``trace_volume`` on the flagship."""
    from protosam_tpu_torch.tools import (bench_fc2, microbench_attn,
                                          trace_volume)
    from protosam_tpu_torch.tools.trace_volume import short_name

    def counted(fn):
        zero_counts(counters)
        result = fn()
        return result, read_counts(counters)

    fc2, counts = counted(lambda: bench_fc2.main(["--reps", "5"]))
    log(f"phase 6 bench_fc2: kernel launches {counts}")
    fc2_launches = counts["dense_residual"]
    if fc2_launches == 0:
        raise AssertionError("bench_fc2 never launched K6")
    attn, counts = counted(lambda: microbench_attn.main(["--reps", "5"]))
    attn_launches = {"packed_masked_attention":
                     counts["packed_masked_attention"],
                     "bf16_scores": counts["bf16_scores"]}
    log(f"phase 6 microbench_attn: kernel launches {counts}")
    if min(attn_launches.values()) == 0:
        raise AssertionError(f"microbench_attn did not launch K2 and its "
                             f"bf16-score variant: {attn_launches}")
    tv = trace_volume.main(["--config", "flagship", "--top", "5"])
    log(f"phase 6 trace_volume flagship: idle share "
        f"{100 * tv['idle_share']:.1f}%, top five kernels "
        f"{[(short_name(k['name']), round(k['ms'], 2)) for k in tv['top']]}")
    return {"fc2": fc2, "fc2_launches": fc2_launches,
            "microbench_attn": attn, "attn_launches": attn_launches}


# the eval fold of phase 7: CHAOS-T2's shape (its _SEP needs 20 scan ids;
# 256² slices, ~30 a scan), four ellipsoid organs (labels 1-4: liver, right
# kidney, left kidney, spleen) over the middle two-thirds of the slices
FOLD_SCANS, FOLD_Z, FOLD_HW = 20, 30, 256
FOLD_ORGANS = {1: (96, 80), 2: (160, 176), 3: (80, 176), 4: (176, 80)}
FOLD_NAMES = ["BG", "LIVER", "RK", "LK", "SPLEEN"]


def write_fold(base_dir: str, seed: int = 0) -> str:
    """The synthetic CHAOS-T2 fold (the recipe of the tests' synthetic
    dataset at this size), written with the port's ``write_nii``: image and
    label volumes and the classmaps the data layer reads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from protosam_tpu_torch.data.nifti import NiftiImage, write_nii

    zz, yy, xx = np.mgrid[:FOLD_Z, :FOLD_HW, :FOLD_HW].astype(np.float32)
    cz, rz = (FOLD_Z - 1) / 2.0, FOLD_Z / 3.0

    def scan(i: int) -> dict:
        rng = np.random.default_rng(seed + i)
        img = rng.normal(100, 20, (FOLD_Z, FOLD_HW, FOLD_HW)).astype(
            np.float32)
        lbl = np.zeros((FOLD_Z, FOLD_HW, FOLD_HW), np.int16)
        for cls, (cy, cx) in FOLD_ORGANS.items():
            r = 4.0 * (7 + (i + cls) % 3)
            blob = (((yy - cy) / r) ** 2 + ((xx - cx) / r) ** 2
                    + ((zz - cz) / rz) ** 2) <= 1.0
            lbl[blob] = cls
            img[blob] += 80 + 10 * cls
        write_nii(NiftiImage(img, (1.5, 1.5, 5.0)),
                  f"{base_dir}/image_{i}.nii.gz")
        write_nii(NiftiImage(lbl, (1.5, 1.5, 5.0)),
                  f"{base_dir}/label_{i}.nii.gz")
        zs = {FOLD_NAMES[c]: sorted(int(z) for z in
                                    np.unique(np.where(lbl == c)[0]))
              for c in FOLD_ORGANS}
        zs["BG"] = list(range(FOLD_Z))
        return zs

    with ThreadPoolExecutor(8) as ex:
        per_scan = list(ex.map(scan, range(1, FOLD_SCANS + 1)))
    classmap = {name: {str(i + 1): zs[name] for i, zs in enumerate(per_scan)}
                for name in FOLD_NAMES}
    for fname in ("classmap_1.json", "classmap_100.json"):
        with open(os.path.join(base_dir, fname), "w") as f:
            json.dump(classmap, f)
    return base_dir


def eval_config(fold: str, sam_ver: str, log_dir: str = "", **extra):
    """``run_protosam.sh mri``'s settings (DINOv2-L/14 at 672, CHAOST2 fold
    0, right kidney, support scan 4, cca, organ slices only, seed 42) with
    ``protosam_sam_ver`` given; bf16, ``slice_batch`` 4; ``extra`` as
    further ``key=value`` overrides."""
    from protosam_tpu_torch.utils.config import load_config

    argv = ["with", "modelname=dinov2_l14", "base_model=alpnet",
            "coarse_pred_only=False", f"protosam_sam_ver={sam_ver}",
            "curr_cls=rk", "eval_fold=0", "dataset=CHAOST2_Superpix_672",
            "proto_grid_size=8", "seed=42", "do_cca=True",
            "skip_no_organ_slices=True", "lora=0", "support_idx=[4]",
            "input_size=(672, 672)", f"path.CHAOST2_672.data_dir={fold}",
            "dtype=bfloat16", "slice_batch=4"]
    argv += [f"{k}={v}" for k, v in extra.items()]
    cfg = load_config(argv)
    cfg.log_dir = log_dir
    return cfg


def save_snapshots(cfg, tmp: str) -> tuple[str, str]:
    """The seeded weights ``build_models(cfg)`` makes (the coarse model from
    ``cfg.seed``, SAM from ``cfg.seed + 1``), f32, as reference ``.pth``
    files: an ALPNet snapshot (``encoder.``-prefixed DINOv2-L/14 keys) and
    a SAM ViT-B state_dict, which MedSAM reuses."""
    from protosam_tpu_torch.eval.protosam_eval import (SAM_IMAGE_SIZE,
                                                       SAM_VERSIONS)
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
    from protosam_tpu_torch.models.sam.registry import build_sam
    from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

    with torch.device("meta"):
        coarse = FewShotSeg(image_size=cfg.input_size[0],
                            which_model=cfg.modelname,
                            proto_grid_size=cfg.proto_grid_size)
        sam = build_sam(SAM_VERSIONS[cfg.protosam_sam_ver],
                        image_size=SAM_IMAGE_SIZE)
    paths = (f"{tmp}/alpnet_dinov2_l14.pth", f"{tmp}/sam_vit_b.pth")
    torch.save(synthetic_state_dict(coarse, cfg.seed), paths[0])
    torch.save(synthetic_state_dict(sam, cfg.seed + 1), paths[1])
    return paths


def counted_eval(tag: str, cfg, pipe, counters: dict, mode: str = "volume"
                 ) -> tuple[dict, np.ndarray]:
    """``run_eval`` with the counts zeroed just before and read just after;
    K1-K4 must have launched.  The masks are taken from the pipeline's own
    calls as they return."""
    from protosam_tpu_torch.eval.protosam_eval import run_eval

    name = "forward_volume" if mode == "volume" else "forward"
    fn, masks = getattr(pipe, name), []

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        masks.append(out[0].cpu().numpy())
        return out

    setattr(pipe, name, recorded)
    zero_counts(counters)
    try:
        result = run_eval(cfg, pipe=pipe, mode=mode, profile=True)
    finally:
        delattr(pipe, name)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    masks = np.concatenate(masks) if mode == "volume" else np.stack(masks)
    result["launches"] = launches
    log(f"{tag}: {result['n_slices']} slices, meanDice "
        f"{result['mar_val_batches_meanDice']:.5f}, "
        f"{result['slices_per_sec']:.2f} slices/s; kernel launches "
        f"{launches}")
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched in run_eval: "
                             f"{missing}")
    if masks.shape != (result["n_slices"], *cfg.input_size):
        raise AssertionError(f"{tag}: masks {masks.shape}")
    return result, masks


def _metrics(result: dict) -> dict:
    return {k: v for k, v in result.items()
            if k not in ("slices_per_sec", "stage_timings", "launches")}


def phase_eval(counters: dict, smi: str) -> dict:
    """The eval entry point on a NIfTI fold written here: ``run_eval`` for
    ProtoSAM (7a) and ProtoMedSAM (7b) built in memory and from ``.pth``
    files of the same seeded weights, then rotation TTA (7c).  Returns the
    launch counts of 7a's ``.pth`` run in ``volume`` mode."""
    import os
    import tempfile

    from protosam_tpu_torch.eval.protosam_eval import build_models
    from protosam_tpu_torch.utils.convert import load_sam_pth

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fold = os.path.join(tmp, "chaos")
        os.makedirs(fold)
        write_fold(fold)
        cfg = eval_config(fold, "sam_b")
        alpnet_pth, sam_pth = save_snapshots(cfg, tmp)
        log(f"phase 7 eval: wrote a {FOLD_SCANS}-scan fold of {FOLD_Z} x "
            f"{FOLD_HW}² slices and the .pth snapshots in "
            f"{time.perf_counter() - t0:.1f} s")
        for tag, sam_ver in (("7a ProtoSAM", "sam_b"),
                             ("7b ProtoMedSAM", "medsam")):
            mem_cfg = eval_config(fold, sam_ver,
                                  log_dir=os.path.join(tmp, "log"))
            pipe = build_models(mem_cfg)
            mem, mem_masks = counted_eval(f"phase {tag} in memory", mem_cfg,
                                          pipe, counters)
            del pipe
            if not os.path.exists(os.path.join(tmp, "log",
                                               "protosam_eval_result.json")):
                raise AssertionError("run_eval wrote no result to log_dir")
            pth_cfg = eval_config(fold, sam_ver,
                                  reload_model_path=alpnet_pth)
            pipe = build_models(pth_cfg, sam_state=load_sam_pth(sam_pth))
            pth, pth_masks = counted_eval(f"phase {tag} from .pth", pth_cfg,
                                          pipe, counters)
            same = np.array_equal(pth_masks, mem_masks)
            log(f"phase {tag}: .pth build vs in-memory build: masks "
                f"bit-equal {same}, metrics equal "
                f"{_metrics(pth) == _metrics(mem)}")
            if not same or _metrics(pth) != _metrics(mem):
                raise AssertionError(f"{tag}: the .pth build differs from "
                                     f"the in-memory build")
            vol_ms = (pth["stage_timings"]["volume_chunk"]["total_s"]
                      / pth["n_slices"] * 1e3)
            log(f"phase {tag} [{smi}]: run_eval {pth['slices_per_sec']:.2f} "
                f"slices/s ({1e3 / pth['slices_per_sec']:.2f} ms/slice) "
                f"beside forward_volume {vol_ms:.2f} ms/slice on the same "
                f"{pth['n_slices']} slices")
            if sam_ver == "sam_b":
                eval_launches = pth["launches"]
                slc, slc_masks = counted_eval(f"phase {tag} per_slice",
                                              pth_cfg, pipe, counters,
                                              mode="per_slice")
                gaps = {k: abs(slc[k] - pth[k]) for k in (
                    "mar_val_batches_meanDice", "mar_val_batches_meanPrec",
                    "mar_val_al_batches_meanRec",
                    "mar_val_al_batches_meanIOU")}
                dices = [dice(torch.from_numpy(a), torch.from_numpy(b))
                         for a, b in zip(slc_masks, pth_masks)]
                mean = sum(dices) / len(dices)
                log(f"phase {tag}: per_slice vs volume: metric gaps {gaps}, "
                    f"mask Dice mean {mean:.5f} min {min(dices):.5f}")
                if max(gaps.values()) > 1e-3 or mean < 0.99:
                    raise AssertionError(f"{tag}: per_slice and volume "
                                         f"disagree")
            del pipe
    phase_rotation()
    log(f"phase 7 eval: {time.perf_counter() - t0:.1f} s in all")
    return eval_launches


def phase_rotation() -> None:
    """7c: rotation TTA.  The rotate / reverse ops on the card against the
    CPU (1e-5), then ``forward(degrees_rotate=15)`` of phase 3's tiny f32
    pipeline on the card against the CPU (Dice >= 0.99, scores 1e-4)."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.ops.rotate import (reverse_tensor,
                                               rotate_tensor_no_crop)
    from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    g = torch.Generator().manual_seed(11)
    err = 0.0
    for shape in ((2, 1, 64, 64), (1, 3, 63, 77), (1, 2, 672, 672)):
        x = torch.randn(shape, generator=g)
        for degrees in (15, -15, 30, 90):
            rot, size = rotate_tensor_no_crop(x, degrees)
            grot, gsize = rotate_tensor_no_crop(x.cuda(), degrees)
            back = reverse_tensor(rot, *size, -degrees)
            gback = reverse_tensor(grot, *gsize, -degrees)
            if gsize != size or gback.shape != back.shape:
                raise AssertionError("rotation shapes differ on the card")
            err = max(err, (grot.cpu() - rot).abs().max().item(),
                      (gback.cpu() - back).abs().max().item())
    log(f"phase 7c rotation ops: card vs CPU max abs err {err:.2e}")
    if err > 1e-5:
        raise AssertionError(f"rotation ops: card vs CPU {err} > 1e-5")

    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                              image_size=126, sam_size=256,
                              dtype=torch.float32, seed=3,
                              config=ProtoSAMConfig(image_size=(256, 256),
                                                    max_ccs=4))
        q = smooth_volume(1, 126, seed=4).to(dev)
        pred, scores = pipe.forward(q, synthetic_episode(126, dev, 5),
                                    degrees_rotate=15)
        outs[dev] = (pred.cpu(), scores.cpu())
    d = dice(outs["cuda"][0], outs["cpu"][0])
    score_err = (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()
    log(f"phase 7c rotation TTA (15°): tiny pipeline card vs CPU Dice "
        f"{d:.5f}, max score diff {score_err:.2e}, card fg share "
        f"{outs['cuda'][0].mean().item():.4f}")
    if d < 0.99 or score_err > 1e-4:
        raise AssertionError("rotation TTA: card and CPU disagree")


def main() -> int:
    from protosam_tpu_torch.ops.alp import alp_match_fused
    from protosam_tpu_torch.ops.attention import \
        masked_flash_attention_packed
    from protosam_tpu_torch.ops.cca import label_components
    from protosam_tpu_torch.ops.mlp import dense_residual, mlp_fused
    from protosam_tpu_torch.ops.norm import layer_norm_rows
    from protosam_tpu_torch.ops.quant import (int8_matmul_dequant,
                                              quantize_rows)
    from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention

    # kernel -> (its wrapper, the wrapper's count of its launches)
    counters = {
        "layer_norm_rows": (layer_norm_rows, "launches"),
        "packed_masked_attention": (masked_flash_attention_packed,
                                    "launches"),
        "relpos_patch_attention": (relpos_patch_attention, "launches"),
        "cca_label": (label_components, "launches"),
        "alp_match": (alp_match_fused, "launches"),
        "dense_residual": (dense_residual, "launches"),
        "mlp_fused": (mlp_fused, "launches"),
        "quantize_rows": (quantize_rows, "launches"),
        "int8_dense": (int8_matmul_dequant, "launches"),
        "bf16_scores": (masked_flash_attention_packed,
                        "bf16_score_launches"),
    }
    smi = phase_device()
    phase_build()
    checks = phase_kernels()
    phase_wiring()
    flagship, bf16_preds, bf16_walls = phase_flagship(counters)
    int8 = phase_flagship_int8(counters, bf16_preds, bf16_walls)
    del bf16_preds
    launches = phase_vith(counters)
    tools = phase_tools(counters)
    eval_launches = phase_eval(counters, smi)
    log(json.dumps(kernel_report(checks, launches, flagship, int8, tools,
                                 eval_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
