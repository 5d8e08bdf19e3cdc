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
   on the card to the CPU;
8. training, on the same fold with its superpixel maps: 8a ``train()`` at
   DINOv2-L/14 672, bf16 with f32 master weights, SGD, one episode a
   step, 4 steps with snapshots every 2, then a resume to step 5: finite
   losses, K1 and K2 launched forward and backward, K5 never; the median
   ms/step, the batch wait apart from it and the peak memory are printed,
   and ``tools.trace_train_step`` times the step alone and traces it;
   8b K1 at (4864, 1024) and K2 at (2, 2432, 3072), 2305 valid, under
   grad against the plain versions' autograd (bf16 2e-2·max(1, max|ref|),
   f32 1e-4), each backward's device time beside the library's, and the
   tiny f32 model's train step on the card against the CPU (1e-4); 8c the
   training CLI's default ``dlfcn_res101`` at 252 px, 3 steps, finite;
   8d ``run_alpnet_eval`` at DINOv2-L/14 672 with ``do_cca`` and
   test-time training on 2 query slices (K1-K3 launched, slices/s
   printed), and the tiny f32 model's eval on the card against the CPU
   (metrics within 1e-6);
9. the SAM tools and the server: 9a ``run_eval(base_model="SAM")``, the
   oracle, with SAM ViT-B at 1024 in bf16 (``utils.synthetic.
   structured_sam_state_dict`` weights) and JAX's 32² grid at 64 points a
   batch on a fold of 20 scans of 6 x 256² slices (20 organ slices), once
   with JAX's score filters and once with ``OPEN_FILTERS``; K1 and K4 must
   launch, slices/s and records a slice are printed; 9b the generator with
   crop_n_layers=1 and min_mask_region_area=100 on one 672² slice (K3 must
   launch), then the tiny SAM in f32 on the card against the CPU (the same
   keys and count, boxes within 1 px, masks at Dice >= 0.99); 9c the
   predictor (a point, a box, the first call's logits as ``mask_input``)
   at ViT-B, then the tiny SAM card vs CPU (Dice >= 0.99, IoU 1e-4); 9e the
   ViT-B decoder exported with ``torch.export`` and reloaded, against
   ``Sam.decode`` (1e-5, K1 launched by the program); 9d ``serve`` in a
   thread with phase 4's flagship build: /healthz names the card, the
   support, one slice and 8 slices, each request twice (ms printed), K1-K4
   launched from request threads only, the volume's masks bit-equal to
   ``forward_volume``'s; 9f ``tools/replay_goldens`` (the 36 recorded
   reference masks in f32 and bf16; f32 Dice >= 0.99 everywhere);
10. data preparation and the host libraries: 10a ``prepare_dataset`` of 2
   raw scans of phase 7's fold at 672 on the card (native Felzenszwalb, one
   K3 call a scan for the foreground masks), its ``superpix_volume``
   bit-equal to its own CPU run; 10b the 20-scan fold at 256 (classmaps
   checked); 10c ``train()`` 3 steps at phase 8a's settings on 10b's
   superpixels (K1, K2 forward and backward); 10d ``run_eval`` (7a's
   configuration) on the native NIfTI feeder (its calls counted), its
   ingest within 2e-3 of the numpy ingest, every mask dumped; 10e the
   same with ``use_clahe=True`` (K1-K4); 10f ``tools/run_agreement``
   against 10d's masks, which must read 1.0 and exit 0;
11. the polyp eval, multi-GPU and the launcher, at the flagship's width:
   11a ``run_eval(dataset="polyps")`` (``run_protosam.sh polyp``'s
   settings with SAM ViT-B, bf16) on a Kvasir-like fold written with the
   port's ``write_png`` (4 train and 16 test RGB images at 576 x 720,
   their rows filtered with the five PNG filters in turn),
   K1-K4 launched, slices/s and the mean Dice printed, then the tiny f32
   pipeline's ``run_eval_polyp`` on the card against the CPU (metrics
   within 1e-6); 11b one ``SuperpixPolypDataset`` episode with
   ``get_polyp_transform`` on the host (ms printed); 11c dp, tp and pp on
   two ranks that share the card (gloo, passed by the phase; its
   send/recv of CUDA tensors staged through the host): dp masks
   bit-equal to ``forward_volume``'s (scores 1e-5), tp masks at mean Dice
   >= 0.99 (the minimum printed), pp masks equal, K1-K4 launched in every
   dp and tp rank and across pp's two stages, then
   ``tools.measure_dp_scaling``'s overhead; 11d
   ``protosam_tpu_torch/run_protosam.sh polyp`` with its defaults (SAM
   ViT-H) from a directory whose ``data/polyps`` is 11a's fold: exit 0 and
   its result printed.

Then one JSON line with the kernels' numbers (each with its bound from
``tools.roofline.kernel_cost`` and, where one PyTorch call computes the
same function, that call's time as ``library_ms``) and, last, the result
line.  Imports only torch, numpy, scipy (through the data layer) and
protosam_tpu_torch.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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
                  tools: dict, eval_launches: dict, train: dict,
                  alpnet: dict, sam_tools: dict, data: dict,
                  polyp: dict) -> dict:
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
    in ``csrc/attention.cu``; K7 its ``check_exchange`` result.
    ``train_launches`` / ``train_backward_calls`` count the 4 steps of the
    DINOv2-L training run (phase 8a), ``alpnet_eval_launches`` the ALPNet
    eval with TTT (phase 8d); K1 and K2 carry their backward's time a call
    (phase 8b) beside the library's.  ``sam_tools_launches`` counts the
    oracle, the generator and the predictor (9a-9c, summed; by sub-phase
    in ``sam_tools_launches_by_phase``), ``serve_launches`` the server's
    requests (9d).  ``data_launches`` counts phase 10 (summed; by
    sub-phase in ``data_launches_by_phase``: 10a-10b ``prepare_dataset``,
    10c the training on its superpixels, 10d-10f ``run_eval`` on the
    native feeder, with CLAHE and through ``run_agreement``), and
    ``data_backward_calls`` 10c's backward calls.  ``polyp_launches``
    counts phase 11 (summed; by sub-phase and rank in
    ``polyp_launches_by_phase``: 11a ``run_eval(dataset="polyps")``, 11c
    dp, tp and pp in each of the two ranks)."""
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
                 "train_launches": train["launches"].get(name, 0),
                 "train_backward_calls":
                     train["backward_calls"].get(name, 0),
                 "alpnet_eval_launches": alpnet["launches"].get(name, 0),
                 "sam_tools_launches": sum(
                     c.get(name, 0) for c in sam_tools["sam_tools"].values()),
                 "sam_tools_launches_by_phase": {
                     k: c.get(name, 0)
                     for k, c in sam_tools["sam_tools"].items()},
                 "serve_launches": sam_tools["serve"].get(name, 0),
                 "data_launches": sum(c.get(name, 0) for c in
                                      data["launches"].values()),
                 "data_launches_by_phase": {
                     k: c.get(name, 0) for k, c in data["launches"].items()},
                 "data_backward_calls":
                     data["backward_calls_10c"].get(name, 0),
                 "polyp_launches": sum(c.get(name, 0) for c in
                                       polyp["launches"].values()),
                 "polyp_launches_by_phase": {
                     k: c.get(name, 0) for k, c in polyp["launches"].items()},
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 **_numbers(main)}
        if name in _DESIGN:
            entry.update(design=_DESIGN[name],
                         rerun_identical=all(r["rerun_identical"]
                                             for r in rows))
        if name in INT8_KERNELS:
            entry.update(per_shape={r["label"]: _numbers(r) for r in rows})
        if name in train["kernels_under_grad"]:
            entry.update(under_grad=train["kernels_under_grad"][name])
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


def write_fold(base_dir: str, seed: int = 0, depth: int = FOLD_Z) -> str:
    """The synthetic CHAOS-T2 fold (the recipe of the tests' synthetic
    dataset at this size), ``depth`` slices a scan, written with the port's
    ``write_nii``: image, label and superpixel volumes and the classmaps
    the data layer reads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from protosam_tpu_torch.data.nifti import NiftiImage, write_nii

    zz, yy, xx = np.mgrid[:depth, :FOLD_HW, :FOLD_HW].astype(np.float32)
    cz, rz = (depth - 1) / 2.0, depth / 3.0
    # the superpixel maps the trainer reads: a 4 x 4 grid of blocks (ids
    # 1-16), the tests' recipe
    cell = FOLD_HW // 4
    superpix = (yy // cell * 4 + xx // cell + 1).astype(np.int16)

    def scan(i: int) -> dict:
        rng = np.random.default_rng(seed + i)
        img = rng.normal(100, 20, (depth, FOLD_HW, FOLD_HW)).astype(
            np.float32)
        lbl = np.zeros((depth, FOLD_HW, FOLD_HW), np.int16)
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
        write_nii(NiftiImage(superpix, (1.5, 1.5, 5.0)),
                  f"{base_dir}/superpix-MIDDLE_{i}.nii.gz")
        zs = {FOLD_NAMES[c]: sorted(int(z) for z in
                                    np.unique(np.where(lbl == c)[0]))
              for c in FOLD_ORGANS}
        zs["BG"] = list(range(depth))
        return zs

    with ThreadPoolExecutor(8) as ex:
        per_scan = list(ex.map(scan, range(1, FOLD_SCANS + 1)))
    classmap = {name: {str(i + 1): zs[name] for i, zs in enumerate(per_scan)}
                for name in FOLD_NAMES}
    for fname in ("classmap_1.json", "classmap_100.json"):
        with open(os.path.join(base_dir, fname), "w") as f:
            json.dump(classmap, f)
    return base_dir


def eval_argv(fold: str, sam_ver: str, **extra) -> list[str]:
    """``run_protosam.sh mri``'s settings (DINOv2-L/14 at 672, CHAOST2 fold
    0, right kidney, support scan 4, cca, organ slices only, seed 42) with
    ``protosam_sam_ver`` given; bf16, ``slice_batch`` 4; ``extra`` as
    further ``key=value`` overrides: the CLI's ``with ...`` arguments."""
    argv = ["with", "modelname=dinov2_l14", "base_model=alpnet",
            "coarse_pred_only=False", f"protosam_sam_ver={sam_ver}",
            "curr_cls=rk", "eval_fold=0", "dataset=CHAOST2_Superpix_672",
            "proto_grid_size=8", "seed=42", "do_cca=True",
            "skip_no_organ_slices=True", "lora=0", "support_idx=[4]",
            "input_size=(672, 672)", f"path.CHAOST2_672.data_dir={fold}",
            "dtype=bfloat16", "slice_batch=4"]
    return argv + [f"{k}={v}" for k, v in extra.items()]


def eval_config(fold: str, sam_ver: str, log_dir: str = "", **extra):
    """The configuration of ``eval_argv(fold, sam_ver, **extra)`` with
    ``log_dir``."""
    from protosam_tpu_torch.utils.config import load_config

    cfg = load_config(eval_argv(fold, sam_ver, **extra))
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
            if k not in ("slices_per_sec", "trace", "launches")}


def phase_eval(counters: dict, smi: str, tmp: str
               ) -> tuple[dict, str, float]:
    """The eval entry point on a NIfTI fold written under ``tmp``:
    ``run_eval`` for ProtoSAM (7a) and ProtoMedSAM (7b) built in memory and
    from ``.pth`` files of the same seeded weights, then rotation TTA (7c).
    Returns the launch counts of 7a's ``.pth`` run in ``volume`` mode, the
    fold's directory and that run's slices/s."""
    import os

    from protosam_tpu_torch.eval.protosam_eval import build_models
    from protosam_tpu_torch.utils.convert import load_sam_pth

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
        vol_ms = pth["trace"]["eval.segment"]["total_ms"] / pth["n_slices"]
        log(f"phase {tag} [{smi}]: run_eval {pth['slices_per_sec']:.2f} "
            f"slices/s ({1e3 / pth['slices_per_sec']:.2f} ms/slice) "
            f"beside forward_volume {vol_ms:.2f} ms/slice on the same "
            f"{pth['n_slices']} slices")
        if sam_ver == "sam_b":
            eval_launches, eval_sps = pth["launches"], pth["slices_per_sec"]
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
    return eval_launches, fold, eval_sps


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



# the kernels every training step on DINOv2 runs, forward and backward
TRAIN_KERNELS = ["layer_norm_rows", "packed_masked_attention"]


def train_config(fold: str, log_dir: str = "", **extra):
    """The training CLI's settings on the phase 7 fold (CHAOST2 fold 0,
    the superpixel maps as pseudo-labels, SGD with its defaults, one
    episode a step, one shot, seed 42), bf16 with f32 master weights,
    every step in the history; ``extra`` as further ``key=value``
    overrides."""
    from protosam_tpu_torch.utils.config import load_config

    argv = ["with", "dataset=CHAOST2_Superpix", "eval_fold=0", "seed=42",
            f"path.CHAOST2_Superpix.data_dir={fold}",
            f"path.CHAOST2.data_dir={fold}",
            f"path.CHAOST2_672.data_dir={fold}", "batch_size=1",
            "dtype=bfloat16", "print_interval=1", "num_workers=4"]
    argv += [f"{k}={v}" for k, v in extra.items()]
    cfg = load_config(argv)
    cfg.log_dir = log_dir
    return cfg


def backward_counts() -> dict:
    from protosam_tpu_torch.ops.attention import \
        masked_flash_attention_packed
    from protosam_tpu_torch.ops.norm import layer_norm_rows

    return {"layer_norm_rows": layer_norm_rows.backward_calls,
            "packed_masked_attention":
                masked_flash_attention_packed.backward_calls}


def zero_backward_counts() -> None:
    from protosam_tpu_torch.ops.attention import \
        masked_flash_attention_packed
    from protosam_tpu_torch.ops.norm import layer_norm_rows

    layer_norm_rows.backward_calls = 0
    masked_flash_attention_packed.backward_calls = 0


def counted_train(tag: str, cfg, counters: dict, steps: int,
                  required: list[str]) -> dict:
    """``train(cfg, steps)`` on the card with every count zeroed just
    before and read just after; the losses must be finite, the kernels of
    ``required`` must have launched forward and backward, and K5 not at
    all (it has no backward)."""
    from protosam_tpu_torch.train.trainer import train

    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    zero_backward_counts()
    t0 = time.perf_counter()
    out = train(cfg, max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bwd = read_counts(counters), backward_counts()
    losses = [h["loss"] for h in out["history"]]
    log(f"{tag}: steps {[h['step'] for h in out['history']]} losses "
        f"{[round(x, 5) for x in losses]} (ce "
        f"{[round(h['ce'], 5) for h in out['history']]}, align "
        f"{[round(h['align_loss'], 5) for h in out['history']]}); kernel "
        f"launches {launches}, backward calls {bwd}; {wall:.1f} s")
    if not losses or not np.all(np.isfinite(losses)) or out["skipped"]:
        raise AssertionError(f"{tag}: non-finite or skipped steps")
    if out["step"] != steps:
        raise AssertionError(f"{tag}: stopped at step {out['step']}")
    missing = [k for k in required if launches[k] == 0 or bwd[k] == 0]
    if missing or launches["alp_match"]:
        raise AssertionError(f"{tag}: kernels {missing} not launched "
                             f"forward and backward, or K5 launched "
                             f"({launches['alp_match']})")
    out.update(launches=launches, backward_calls=bwd,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


def phase_train(counters: dict, smi: str, tmp: str, fold: str) -> dict:
    """8a: ``train()`` at DINOv2-L/14 672, 4 steps with snapshots every 2,
    then a resume to step 5; 8b: K1 and K2 under grad against the plain
    versions' autograd, and the tiny f32 train step card against CPU; 8c:
    the ResNet-101 default at 252 px, 3 steps."""
    import os

    from protosam_tpu_torch.tools import trace_train_step

    t0 = time.perf_counter()
    log_dir = os.path.join(tmp, "train_l14")
    cfg = train_config(fold, log_dir, modelname="dinov2_l14",
                       **{"input_size": "(672, 672)",
                          "save_snapshot_every": 2})
    out = counted_train("phase 8a train dinov2_l14 672", cfg, counters, 4,
                        TRAIN_KERNELS)
    step_ms = float(np.median(out["step_ms"][1:]))
    wait_ms = float(np.median(out["wait_ms"][1:]))
    log(f"phase 8a train [{smi}]: {step_ms:.1f} ms/step (median of steps "
        f"2-4; per step {[round(x, 1) for x in out['step_ms']]}), batch "
        f"wait {wait_ms:.1f} ms (per step "
        f"{[round(x, 1) for x in out['wait_ms']]}), peak memory "
        f"{out['peak_gib']:.2f} GiB")
    snaps = sorted(os.listdir(os.path.join(log_dir, "snapshots")))
    resumed = counted_train("phase 8a resume", cfg, counters, 5,
                            TRAIN_KERNELS)
    if [h["step"] for h in resumed["history"]] != [5]:
        raise AssertionError(f"resume ran {resumed['history']}")
    log(f"phase 8a: snapshots {snaps}; resumed to step {resumed['step']}")
    alone = trace_train_step.run(top=10)
    log(f"phase 8a: the step alone (no prefetch threads, one episode) "
        f"{alone['step_ms']:.1f} ms, device idle "
        f"{100 * alone['idle_share']:.1f}% of a traced step, beside "
        f"train()'s {step_ms:.1f} ms/step")
    result = {"launches": out["launches"],
              "backward_calls": out["backward_calls"],
              "step_ms": step_ms, "wait_ms": wait_ms,
              "peak_gib": out["peak_gib"], "steps": 4,
              "isolated_step_ms": alone["step_ms"],
              "isolated_idle_share": alone["idle_share"],
              **phase_train_kernels()}

    cfg = train_config(fold, os.path.join(tmp, "train_res101"),
                       modelname="dlfcn_res101")
    res = counted_train(f"phase 8c train dlfcn_res101 {cfg.input_size[0]}",
                        cfg, counters, 3, [])
    log(f"phase 8c: {float(np.median(res['step_ms'][1:])):.1f} ms/step, "
        f"batch wait {float(np.median(res['wait_ms'][1:])):.1f} ms, peak "
        f"memory {res['peak_gib']:.2f} GiB")
    trace_train_step.run("dlfcn_res101", cfg.input_size[0], top=6)
    log(f"phase 8a-8c: {time.perf_counter() - t0:.1f} s")
    return result


def _grad_error(got, want, kind: str) -> tuple[float, float]:
    from protosam_tpu_torch.tools.timing import bf16_error

    if kind == "bf16":
        return bf16_error(got, want, BF16_TOL)
    return (got.float() - want.float()).abs().max().item(), F32_TOL


def phase_train_kernels() -> dict:
    """8b: K1 at the DINOv2-L rows (4864, 1024) and K2 at its qkv (2, 2432,
    3072), 2305 valid, under grad: the output and every gradient against
    the plain version's autograd in f32, bf16 and f32; the backward's
    device time per call beside the library's (``F.layer_norm``, SDPA on
    the valid keys).  Then the tiny f32 model's train step on the card
    against the CPU."""
    from protosam_tpu_torch.ops.attention import (
        masked_attention_packed_plain, masked_flash_attention_packed)
    from protosam_tpu_torch.ops.norm import (layer_norm_rows,
                                             layer_norm_rows_plain)
    from protosam_tpu_torch.tools.timing import device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(8)
    randn = lambda *s: torch.randn(*s, generator=g).to(dev)
    grad = torch.autograd.grad
    out: dict = {}

    rows, c = 4864, 1024
    x0, w0, b0 = randn(rows, c) * 3 + 1, 1 + 0.1 * randn(c), 0.1 * randn(c)
    gy = randn(rows, c)
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = x0.to(dt).requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        xr = x.detach().float().requires_grad_()
        before = layer_norm_rows.backward_calls
        y = layer_norm_rows(x, w, b, 1e-6)
        got = (y, *grad(y, (x, w, b), gy.to(dt)))
        yr = layer_norm_rows_plain(xr, w, b, 1e-6, torch.float32)
        want = (yr, *grad(yr, (xr, w, b), gy.to(dt).float()))
        errs = [_grad_error(a, e, kind) for a, e in zip(got, want)]
        log(f"phase 8b K1 under grad ({rows}x{c} {kind}): y, dx, dw, db "
            f"max abs err {[f'{e:.2e}' for e, _ in errs]} (bounds "
            f"{[f'{t:.2e}' for _, t in errs]}); backward calls "
            f"{layer_norm_rows.backward_calls - before}")
        if any(e > t for e, t in errs) or \
                layer_norm_rows.backward_calls == before:
            raise AssertionError(f"K1 under grad ({kind}) disagrees")
        if kind == "bf16":
            fwd = device_ms(lambda: layer_norm_rows(x, w, b, 1e-6))
            both = device_ms(lambda: grad(layer_norm_rows(x, w, b, 1e-6),
                                          (x, w, b), gy.to(dt)))
            lib = device_ms(lambda: grad(F.layer_norm(
                x, (c,), w.to(dt), b.to(dt), 1e-6), (x, w, b), gy.to(dt)))
            lib_fwd = device_ms(lambda: F.layer_norm(x, (c,), w.to(dt),
                                                     b.to(dt), 1e-6))
            out["layer_norm_rows"] = {
                "forward_ms": fwd.median_ms,
                "backward_ms": both.median_ms - fwd.median_ms,
                "library_backward_ms": lib.median_ms - lib_fwd.median_ms,
                "grad_max_abs_err": max(e for e, _ in errs)}

    b_, s, n_valid, nh, hd = 2, 2432, 2305, 16, 64
    q0 = randn(b_, s, 3 * nh * hd)
    go = randn(b_, s, nh * hd)
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        qkv = q0.to(dt).requires_grad_()
        ref = qkv.detach().float().requires_grad_()
        before = masked_flash_attention_packed.backward_calls
        attn = lambda t: masked_flash_attention_packed(
            t, scale=hd ** -0.5, num_heads=nh, n_valid=n_valid)
        o = attn(qkv)
        got = (o, grad(o, qkv, go.to(dt))[0])
        orr = masked_attention_packed_plain(ref, scale=hd ** -0.5,
                                            num_heads=nh, n_valid=n_valid)
        want = (orr, grad(orr, ref, go.to(dt).float())[0])
        errs = [_grad_error(a, e, kind) for a, e in zip(got, want)]
        log(f"phase 8b K2 under grad ({b_}x{s}x{3 * nh * hd} {kind}, "
            f"{n_valid} valid): out, dqkv max abs err "
            f"{[f'{e:.2e}' for e, _ in errs]} (bounds "
            f"{[f'{t:.2e}' for _, t in errs]}); backward calls "
            f"{masked_flash_attention_packed.backward_calls - before}")
        if any(e > t for e, t in errs) or \
                masked_flash_attention_packed.backward_calls == before:
            raise AssertionError(f"K2 under grad ({kind}) disagrees")
        del ref, orr, want
        if kind == "bf16":
            fwd = device_ms(lambda: attn(qkv), reps=3, runs=3)
            both = device_ms(lambda: grad(attn(qkv), qkv, go.to(dt)),
                             reps=3, runs=3)

            def sdpa(t):
                q, k, v = (t.reshape(b_, s, 3, nh, hd)[:, :, i]
                           .transpose(1, 2) for i in range(3))
                return F.scaled_dot_product_attention(
                    q, k[:, :, :n_valid], v[:, :, :n_valid],
                    scale=hd ** -0.5)

            lib = device_ms(lambda: grad(sdpa(qkv), qkv,
                                         go.to(dt).reshape(b_, s, nh, hd)
                                         .transpose(1, 2)), reps=3, runs=3)
            lib_fwd = device_ms(lambda: sdpa(qkv), reps=3, runs=3)
            out["packed_masked_attention"] = {
                "forward_ms": fwd.median_ms,
                "backward_ms": both.median_ms - fwd.median_ms,
                "library_backward_ms": lib.median_ms - lib_fwd.median_ms,
                "grad_max_abs_err": max(e for e, _ in errs)}
    for name, row in out.items():
        log(f"phase 8b {name} backward (plain VJP): "
            f"{row['backward_ms']:.4f} ms a call beside its forward "
            f"{row['forward_ms']:.4f}; the library's backward "
            f"{row['library_backward_ms']:.4f}")
    tiny_step_card_vs_cpu()
    return {"kernels_under_grad": out}


def tiny_step_card_vs_cpu() -> None:
    """The tiny f32 model (``dinov2_t14`` at 64²): one train step on the
    card (K1 and K2 forward and backward) and on the CPU, same seeded
    weights and episode, TF32 off: loss and updated params within 1e-4."""
    from protosam_tpu_torch.train.step import (Batch, make_optimizer,
                                               train_step)
    from protosam_tpu_torch.train.trainer import build_coarse_model
    from protosam_tpu_torch.utils.config import Config

    cfg = Config(modelname="dinov2_t14", input_size=(64, 64),
                 dtype="float32", seed=5)
    rng = np.random.default_rng(9)
    fg = np.zeros((1, 1, 64, 64), np.float32)
    fg[..., 16:44, 20:40] = 1
    lbl = np.zeros((1, 64, 64), np.int32)
    lbl[:, 20:40, 18:46] = 1
    arrays = (rng.standard_normal((1, 1, 3, 64, 64)).astype(np.float32), fg,
              1 - fg,
              rng.standard_normal((1, 1, 3, 64, 64)).astype(np.float32), lbl)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_coarse_model(cfg, dev)
        m = train_step(model, make_optimizer(model.parameters()),
                       Batch.from_numpy(arrays, dev))
        res[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     model.state_dict().items()})
    loss_err = max(abs(res["cuda"][0][k] - res["cpu"][0][k])
                   for k in res["cpu"][0])
    param_err = max((res["cuda"][1][k] - v).abs().max().item()
                    for k, v in res["cpu"][1].items())
    log(f"phase 8b tiny f32 train step card vs CPU: loss/ce/align max diff "
        f"{loss_err:.2e}, updated params max diff {param_err:.2e} (bound "
        f"1e-4); losses {res['cuda'][0]}")
    if loss_err > 1e-4 or param_err > 1e-4:
        raise AssertionError("train step: card and CPU disagree")


def phase_alpnet_eval(counters: dict, smi: str, fold: str) -> dict:
    """8d: ``run_alpnet_eval`` at DINOv2-L/14 672 with ``do_cca`` and
    test-time training (20 steps a slice) on the first query slice of each
    test class (2 in all); K1, K2 and K3 must launch.  Then the tiny
    f32 model's ``run_alpnet_eval`` without TTT on the card against the
    CPU: metrics within 1e-6."""
    from protosam_tpu_torch.eval.alpnet_eval import run_alpnet_eval

    t0 = time.perf_counter()
    cfg = train_config(fold, modelname="dinov2_l14", dataset="CHAOST2",
                       label_sets=0, support_idx=[-1], do_cca=True,
                       ttt=True, **{"input_size": "(672, 672)"})
    zero_counts(counters)
    zero_backward_counts()
    t1 = time.perf_counter()
    res = run_alpnet_eval(cfg, write_preds=False, max_slices=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches, bwd = read_counts(counters), backward_counts()
    n = 2
    log(f"phase 8d run_alpnet_eval dinov2_l14 672 cca + TTT [{smi}]: "
        f"classDice {res['classDice']}, meanDice {res['meanDice']:.5f}; "
        f"{n} slices in {wall:.1f} s, {n / wall:.4f} slices/s; kernel "
        f"launches {launches}, backward calls {bwd}")
    missing = [k for k in TRAIN_KERNELS + ["cca_label"] if launches[k] == 0]
    if missing or not all(bwd.values()):
        raise AssertionError(f"8d: kernels not launched: {missing}, "
                             f"backward {bwd}")
    if not all(np.isfinite(v) for v in res["classDice"].values()):
        raise AssertionError(f"8d: non-finite Dice {res}")

    tiny = {}
    for dev in ("cuda", "cpu"):
        tcfg = train_config(fold, modelname="dinov2_t14", dataset="CHAOST2",
                            label_sets=0, support_idx=[-1], do_cca=True,
                            dtype="float32", seed=5,
                            **{"input_size": "(64, 64)"})
        tiny[dev] = run_alpnet_eval(tcfg, write_preds=False, device=dev,
                                    max_slices=8)
    gap = max(abs(tiny["cuda"][k][c] - tiny["cpu"][k][c])
              for k in ("classDice", "classPrec", "classRec")
              for c in tiny["cpu"][k])
    log(f"phase 8d tiny f32 run_alpnet_eval card vs CPU: max metric gap "
        f"{gap:.2e} (bound 1e-6); meanDice {tiny['cuda']['meanDice']:.6f}")
    if not gap <= 1e-6:
        raise AssertionError("run_alpnet_eval: card and CPU disagree")
    log(f"phase 8d: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "backward_calls": bwd,
            "slices_per_sec": n / wall, "classDice": res["classDice"]}


# the kernels the SAM tools must launch (9a-9c: SAM's encoder); 9b's small
# regions add K3
SAM_KERNELS = ["layer_norm_rows", "relpos_patch_attention"]
ORACLE_DEPTH = 6    # 9a's fold: 20 scans of 6 x 256² slices
# the generator's score filters in 9a's second run and 9b: about half of
# the structured weights' candidates pass each (predicted IoU -0.28 to
# 0.54, stability 0.13 to 0.44 at ViT-B 1024)
OPEN_FILTERS = dict(pred_iou_thresh=0.0, stability_score_thresh=0.3)
SCORE_TOL = 1e-4    # card against CPU: predicted IoU, low-res logits


def counted_call(tag: str, fn, counters: dict, required: list[str]):
    """``fn()`` with every count zeroed just before and read just after;
    the kernels of ``required`` must have launched.  Returns (its result,
    the counts, the wall seconds)."""
    zero_counts(counters)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    log(f"{tag}: kernel launches {launches}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return out, launches, wall


def uint8_slice(size: int, seed: int) -> np.ndarray:
    """A smooth synthetic slice as an (size, size, 3) uint8 image."""
    from protosam_tpu_torch.utils.synthetic import smooth_volume

    x = smooth_volume(1, size, seed)[0].permute(1, 2, 0).numpy()
    return ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)


def tiny_image() -> np.ndarray:
    """The CPU tests' AMG image: recorded slice 2's query, 200 x 240."""
    from protosam_tpu_torch.utils.synthetic import synthetic_agreement_case

    q = synthetic_agreement_case(2)[0][0].transpose(1, 2, 0)[:200, :240]
    return ((q - q.min()) / (q.max() - q.min()) * 255).astype(np.uint8)


def phase_oracle(counters: dict, smi: str, tmp: str):
    """9a: ``run_eval(base_model="SAM")``, the oracle, with SAM ViT-B at
    1024 in bf16 (seeded weights of ``utils.synthetic.
    structured_sam_state_dict``, under which one-point masks cover a
    quarter to two-fifths of the frame: JAX's recipe gives empty ones) and
    JAX's grid (32², 64 points a batch) on a CHAOS-T2-like fold of 20
    scans of 6 x 256² slices (its organ slices of fold 0's test scans,
    20): once with JAX's score filters (0.88, 0.95), which no candidate of
    random weights passes, and once with them at OPEN_FILTERS, so that
    the oracle picks among real records.
    Returns the oracle's SAM (for 9b, 9c and 9e), the counts of the second
    run and its numbers."""
    import os

    from protosam_tpu_torch.eval.protosam_eval import (SAM_IMAGE_SIZE,
                                                       build_sam_oracle,
                                                       run_eval)
    from protosam_tpu_torch.models.sam.registry import build_sam
    from protosam_tpu_torch.utils.synthetic import \
        structured_sam_state_dict

    fold = os.path.join(tmp, "chaos_oracle")
    os.makedirs(fold)
    write_fold(fold, seed=1, depth=ORACLE_DEPTH)
    cfg = eval_config(fold, "sam_b", base_model="SAM")
    with torch.device("meta"):
        state = structured_sam_state_dict(build_sam("vit_b",
                                                    SAM_IMAGE_SIZE),
                                          cfg.seed)
    numbers = {}
    for tag, kw in (("JAX's score filters", {}),
                    ("score filters open", OPEN_FILTERS)):
        wrapper = build_sam_oracle(cfg, sam_state=state, **kw)
        records, generate = [], wrapper.amg.generate

        def counting(*args, _generate=generate, _records=records,
                     **kwargs):
            out = _generate(*args, **kwargs)
            _records.append(len(out))
            return out

        wrapper.amg.generate = counting
        result, launches, wall = counted_call(
            f"phase 9a oracle ({tag})", lambda: run_eval(cfg, pipe=wrapper),
            counters, SAM_KERNELS)
        log(f"phase 9a oracle SAM ViT-B 1024 bf16, {tag} [{smi}]: "
            f"{result['n_slices']} slices, meanDice "
            f"{result['mar_val_batches_meanDice']:.5f}, "
            f"{result['slices_per_sec']:.3f} slices/s ({wall:.1f} s in all), "
            f"AMG records per slice mean {np.mean(records):.2f} (min "
            f"{min(records)}, max {max(records)})")
        if not result["n_slices"] or len(records) != result["n_slices"] \
                or not 0.0 <= result["mar_val_batches_meanDice"] <= 1.0:
            raise AssertionError(f"9a: {result}")
        numbers[tag] = {"slices_per_sec": result["slices_per_sec"],
                        "records_per_slice": float(np.mean(records)),
                        "meanDice": result["mar_val_batches_meanDice"]}
    if not numbers["score filters open"]["records_per_slice"]:
        raise AssertionError("9a: no records with the filters open")
    return wrapper.sam, launches, numbers


def match_records(got: list, want: list, tag: str) -> None:
    """Card records against CPU records: the same keys and count; each
    CPU record's card record (same point and crop, the closest predicted
    IoU) within SCORE_TOL, its box within 1 px, its mask at Dice >= 0.99."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{tag}: {len(got)} records, CPU {len(want)}")
    worst = (1.0, 0.0, 0.0)
    for w in want:
        g = min((g for g in got if g["point_coords"] == w["point_coords"]
                 and g["crop_box"] == w["crop_box"]),
                key=lambda g: abs(g["predicted_iou"] - w["predicted_iou"]),
                default=None)
        if g is None:
            raise AssertionError(f"{tag}: no card record at the CPU "
                                 f"record's point {w['point_coords']}")
        if set(g) != set(w):
            raise AssertionError(f"{tag}: keys {set(g)} vs {set(w)}")
        d = dice(torch.from_numpy(g["segmentation"]),
                 torch.from_numpy(w["segmentation"]))
        box = max(abs(a - b) for a, b in zip(g["bbox"], w["bbox"]))
        iou = abs(g["predicted_iou"] - w["predicted_iou"])
        worst = (min(worst[0], d), max(worst[1], box), max(worst[2], iou))
    log(f"{tag}: {len(got)} records match the CPU's: Dice min "
        f"{worst[0]:.5f}, bbox max diff {worst[1]:.1f} px, predicted IoU "
        f"max diff {worst[2]:.2e}")
    if worst[0] < 0.99 or worst[1] > 1.0 or worst[2] > SCORE_TOL:
        raise AssertionError(f"{tag}: card and CPU records disagree")


def phase_amg(counters: dict, smi: str, sam) -> dict:
    """9b: the generator with crop_n_layers=1 and min_mask_region_area=100
    on one 672² slice with 9a's SAM ViT-B (the score filters open, as in
    9a's second run, so that NMS, the crops and the small-region pass see
    real records); K3 must launch.  Then the tiny SAM in f32 on the card
    against the CPU."""
    from protosam_tpu_torch.models.sam.amg import SamAutomaticMaskGenerator
    from protosam_tpu_torch.utils.synthetic import structured_tiny_sam

    gen = SamAutomaticMaskGenerator(sam, crop_n_layers=1,
                                    min_mask_region_area=100, **OPEN_FILTERS)
    img = uint8_slice(672, seed=12)
    recs, launches, wall = counted_call(
        "phase 9b AMG ViT-B 1024 bf16, 672² slice, crops, small regions",
        lambda: gen.generate(image=img), counters,
        SAM_KERNELS + ["cca_label"])
    areas = [r["area"] for r in recs]
    log(f"phase 9b [{smi}]: {len(recs)} records in {wall:.2f} s, areas "
        f"{areas[:5]}...{areas[-3:]}")
    if not recs or recs[0]["segmentation"].shape != (672, 672):
        raise AssertionError("9b: no records")

    kw = dict(points_per_side=8, points_per_batch=32, pred_iou_thresh=0.0,
              stability_score_thresh=0.5, crop_n_layers=1,
              min_mask_region_area=100)
    out = {dev: SamAutomaticMaskGenerator(structured_tiny_sam(dev), **kw)
           .generate(image=tiny_image(), image_size=256)
           for dev in ("cuda", "cpu")}
    match_records(out["cuda"], out["cpu"],
                  "phase 9b tiny SAM f32 card vs CPU")
    return launches


def phase_predictor(counters: dict, sam) -> dict:
    """9c: ``set_image`` and ``predict`` with SAM ViT-B at 1024 (a point, a
    box, then the point with the first call's best low-res logits as
    ``mask_input``); then the tiny SAM in f32 on the card against the CPU
    (masks at Dice >= 0.99, iou_predictions within SCORE_TOL)."""
    from protosam_tpu_torch.models.sam.predictor import SamPredictor
    from protosam_tpu_torch.utils.synthetic import seeded_tiny_sam

    def drive(pred, img, point, box):
        pred.set_image(img)
        m1, iou1, low1 = pred.predict(point_coords=[point], point_labels=[1])
        m2, iou2, _ = pred.predict(box=box, multimask_output=False)
        best = int(np.argmax(iou1))
        m3, iou3, _ = pred.predict(point_coords=[point], point_labels=[1],
                                   mask_input=low1[best][None],
                                   multimask_output=False)
        return [(m1, iou1), (m2, iou2), (m3, iou3)]

    pred = SamPredictor(sam)
    out, launches, wall = counted_call(
        "phase 9c predictor ViT-B 1024 bf16",
        lambda: drive(pred, uint8_slice(672, seed=13), [300.0, 340.0],
                      [200.0, 220.0, 480.0, 500.0]), counters, SAM_KERNELS)
    shapes = [m.shape for m, _ in out]
    log(f"phase 9c: masks {shapes}, iou {[np.round(i, 4).tolist() for _, i in out]}, "
        f"{wall:.2f} s")
    if shapes != [(3, 672, 672), (1, 672, 672), (1, 672, 672)] or \
            not all(np.isfinite(i).all() for _, i in out):
        raise AssertionError("9c: predictor outputs")

    img = tiny_image()[:180, :230]
    res = {dev: drive(SamPredictor(seeded_tiny_sam(dev)), img,
                      [90.0, 80.0], [40.0, 30.0, 160.0, 150.0])
           for dev in ("cuda", "cpu")}
    dices = [dice(torch.from_numpy(a), torch.from_numpy(b))
             for (ma, _), (mb, _) in zip(res["cuda"], res["cpu"])
             for a, b in zip(ma, mb)]
    iou_err = max(float(np.abs(ia - ib).max()) for (_, ia), (_, ib) in
                  zip(res["cuda"], res["cpu"]))
    log(f"phase 9c tiny SAM f32 card vs CPU: mask Dice min {min(dices):.5f}, "
        f"iou_predictions max diff {iou_err:.2e}")
    if min(dices) < 0.99 or iou_err > SCORE_TOL:
        raise AssertionError("9c: card and CPU predictors disagree")
    return launches


def phase_serve(counters: dict, smi: str) -> dict:
    """9d: ``serve`` on 127.0.0.1 in a thread with phase 4's flagship build
    and weights: /healthz names the card; /register_support; /segment one
    slice, then phase 4's 8 slices.  The volume's masks must be bit-equal
    to ``forward_volume`` on the same build and slices, and K1-K4 must
    launch, each from a request thread.  Each request is made twice; the
    ms of both are printed."""
    import io
    import threading
    import urllib.request

    from protosam_tpu_torch import kernels
    from protosam_tpu_torch.serve import serve
    from protosam_tpu_torch.tools.pipeline_profile import build_config
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    pipe = build_config("flagship", "cuda")
    vol = smooth_volume(N_SLICES, 672, seed=6)
    inp = synthetic_episode(672, "cpu", 7)
    httpd = serve(pipe, host="127.0.0.1", port=0, slice_batch=SLICE_BATCH)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=payload,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    def npy(arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        return buf.getvalue()

    threads, launch = set(), kernels.launch

    def recording(*args, **kwargs):
        threads.add(threading.current_thread().name)
        return launch(*args, **kwargs)

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        log(f"phase 9d serve: /healthz {health}")
        if health["device_name"] != torch.cuda.get_device_name(0):
            raise AssertionError("9d: /healthz does not name the card")
        buf = io.BytesIO()
        np.savez(buf, images=inp.supp_imgs.numpy(),
                 masks=inp.fore_mask.numpy())
        kernels.launch = recording
        zero_counts(counters)
        post("/register_support", buf.getvalue())
        ms = {"single": [], "volume": []}
        for _ in range(2):
            for name, arr in (("single", vol[0].numpy()),
                              ("volume", vol.numpy())):
                t0 = time.perf_counter()
                out = np.load(io.BytesIO(post("/segment", npy(arr))))
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "volume":
                    volume = out
        torch.cuda.synchronize()
        launches = read_counts(counters)
    finally:
        kernels.launch = launch
        httpd.shutdown()
        httpd.server_close()
        server.join()
    log(f"phase 9d serve: kernel launches {launches} from threads "
        f"{sorted(threads)}")
    log(f"phase 9d serve [{smi}]: /segment one 672² slice "
        f"{ms['single'][0]:.1f} / {ms['single'][1]:.1f} ms, {N_SLICES} "
        f"slices {ms['volume'][0]:.1f} / {ms['volume'][1]:.1f} ms "
        f"({ms['volume'][1] / N_SLICES:.1f} ms/slice) per request, first / "
        f"second")
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] == 0]
    if missing or not threads or threading.main_thread().name in threads:
        raise AssertionError(f"9d: kernels {missing} not launched, or not "
                             f"from request threads: {threads}")
    with torch.no_grad():
        want, _ = pipe.forward_volume(vol.cuda(), inp.to("cuda"),
                                      slice_batch=SLICE_BATCH)
    same = np.array_equal(volume, want.cpu().numpy())
    log(f"phase 9d serve: volume masks bit-equal to forward_volume: {same} "
        f"(fg share {volume.mean():.4f})")
    if not same:
        raise AssertionError("9d: the server's masks differ from "
                             "forward_volume's")
    return {"launches": launches, "ms": ms}


def phase_export(counters: dict, sam) -> None:
    """9e: the ViT-B decoder exported on the card, reloaded, against
    ``Sam.decode`` in f32 (1e-5); the program's LayerNorms must launch K1
    (the ``ptk::layer_norm_rows`` op)."""
    from protosam_tpu_torch.utils.export import export_decoder, load_exported

    t0 = time.perf_counter()
    blob = export_decoder(sam, num_points=2)
    fn = load_exported(blob)
    g = torch.Generator().manual_seed(14)
    grid, dev = sam.image_size // 16, next(sam.parameters()).device
    args = tuple(t.to(dev) for t in (
        torch.randn(1, 256, grid, grid, generator=g),
        torch.rand(1, 2, 2, generator=g) * sam.image_size,
        torch.tensor([[1, 0]], dtype=torch.int32),
        torch.tensor([[0.1, 0.2, 0.6, 0.7]]) * sam.image_size))
    with torch.no_grad():
        got, launches, _ = counted_call("phase 9e exported decoder",
                                        lambda: fn(*args), counters,
                                        ["layer_norm_rows"])
        want = sam.decode(*args[:4], None, False, False)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    log(f"phase 9e export: {len(blob) / 2**20:.1f} MiB program, reloaded "
        f"decoder vs Sam.decode max abs err {err:.2e} (bound 1e-5), "
        f"{time.perf_counter() - t0:.1f} s")
    if err > 1e-5:
        raise AssertionError("9e: the exported decoder disagrees")


def phase_goldens(smi: str, tmp: str) -> dict:
    """9f: the recorded reference masks replayed on the card, f32 and
    bf16 (``tools/replay_goldens.py``): f32 >= 0.99 everywhere."""
    import os

    from protosam_tpu_torch.tools import replay_goldens

    path = os.path.join(tmp, "replay.json")
    rc = replay_goldens.main(["--out", path])
    with open(path) as f:
        result = json.load(f)
    for tag, row in result["configs"].items():
        log(f"phase 9f goldens [{smi}] {tag}: f32 min "
            f"{row['f32_vs_reference']['min']:.5f}, bf16 min "
            f"{row['bf16_vs_reference']['min']:.5f}, bf16 vs f32 min "
            f"{row['bf16_vs_f32']['min']:.5f}")
    if rc or not result["passes"]:
        raise AssertionError("9f: the golden replay missed its bars")
    return result


def phase_sam_tools(counters: dict, smi: str, tmp: str) -> dict:
    """Phase 9: the SAM tools (9a-9c), the server (9d), the export (9e)
    and the golden replay (9f)."""
    t0 = time.perf_counter()
    sam, oracle, oracle_numbers = phase_oracle(counters, smi, tmp)
    amg = phase_amg(counters, smi, sam)
    predictor = phase_predictor(counters, sam)
    phase_export(counters, sam)
    del sam
    served = phase_serve(counters, smi)
    goldens = phase_goldens(smi, tmp)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return {"sam_tools": {"9a": oracle, "9b": amg, "9c": predictor},
            "serve": served["launches"], "oracle": oracle_numbers,
            "serve_ms": served["ms"], "goldens": goldens}


# ---- phase 10: data preparation, the native feeder, CLAHE, agreement ------

PREP_SCANS = 2       # 10a: raw scans prepared at JAX's default of 672
MR_FG_THRESH = 50 + 1e-4   # prepare_dataset's MR foreground threshold
INGEST_TOL = 2e-3    # native against numpy ingest: JAX's bound


def counted_prepare(tag: str, raw: str, out: str, counters: dict,
                    size: int) -> tuple[dict, float]:
    """``prepare_dataset(raw, out, "MR", size)`` on the card with the counts
    zeroed just before and read just after: one K3 call a scan.  Returns
    the counts and the wall seconds."""
    import glob

    from protosam_tpu_torch.data.prepare import prepare_dataset

    n = len(glob.glob(f"{raw}/image_*.nii.gz"))
    zero_counts(counters)
    t0 = time.perf_counter()
    prepare_dataset(raw, out, "MR", FOLD_NAMES, image_size=size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    log(f"{tag}: {n} scans in {wall:.1f} s ({wall / n:.2f} s a scan); "
        f"kernel launches {launches}")
    if launches["cca_label"] != n:
        raise AssertionError(f"{tag}: {launches['cca_label']} K3 launches "
                             f"for {n} scans, one a scan expected")
    return launches, wall


def phase_prepare(counters: dict, smi: str, tmp: str, fold: str) -> dict:
    """10a: ``prepare_dataset`` of 2 raw scans of phase 7's fold at 672 on
    the card (K3 once a scan), its ``superpix_volume`` bit-equal to its CPU
    run on the same volume; 10b: the whole 20-scan fold at 256, which 10c
    trains on."""
    import os
    import shutil

    from protosam_tpu_torch.data.nifti import read_nii
    from protosam_tpu_torch.data.prepare import felzenszwalb, superpix_volume

    raw = os.path.join(tmp, "raw_two")
    os.makedirs(raw)
    for i in range(1, PREP_SCANS + 1):
        for kind in ("image", "label"):
            shutil.copy(f"{fold}/{kind}_{i}.nii.gz", raw)
    out672 = os.path.join(tmp, "prepared_672")
    launches_a, wall = counted_prepare(
        f"phase 10a prepare_dataset MR 672 [{smi}]", raw, out672, counters,
        672)
    img = read_nii(f"{out672}/image_1.nii.gz")
    sp = read_nii(f"{out672}/superpix-MIDDLE_1.nii.gz")
    t0 = time.perf_counter()
    for z in range(3):
        felzenszwalb(img[z])
    felz_ms = (time.perf_counter() - t0) / 3 * 1e3
    per_slice = [int(len(np.unique(s))) - 1 for s in sp]
    card = superpix_volume(img, MR_FG_THRESH)
    t0 = time.perf_counter()
    cpu = superpix_volume(img, MR_FG_THRESH, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = np.array_equal(card, cpu) and np.array_equal(card, sp)
    log(f"phase 10a: {img.shape[0]} slices of {img.shape[1]}² a scan; "
        f"Felzenszwalb {felz_ms:.1f} ms a 672² slice (one thread); "
        f"superpixels a slice min {min(per_slice)} mean "
        f"{np.mean(per_slice):.1f} max {max(per_slice)}; superpix_volume "
        f"card vs CPU (plain K3, {cpu_s:.1f} s) bit-equal {same}")
    if not same or min(per_slice) < 2:
        raise AssertionError("10a: the card's superpixels differ from the "
                             "CPU's, or a slice has fewer than 2")

    out256 = os.path.join(tmp, "prepared_256")
    launches_b, wall_b = counted_prepare(
        f"phase 10b prepare_dataset MR 256 [{smi}]", fold, out256, counters,
        256)
    with open(f"{out256}/classmap_1.json") as f:
        cmap = json.load(f)
    zs = {name: sum(len(v) for v in by_scan.values())
          for name, by_scan in cmap.items()}
    log(f"phase 10b: classmap_1 {len(cmap)} classes, z slices a class "
        f"{zs}; {wall_b:.1f} s in all")
    if set(cmap) != set(FOLD_NAMES) or min(zs.values()) == 0:
        raise AssertionError(f"10b: classmaps {zs}")
    return {"launches": {"10a": launches_a, "10b": launches_b},
            "s_per_scan_672": wall / PREP_SCANS, "felzenszwalb_ms": felz_ms,
            "superpixels_per_slice": float(np.mean(per_slice)),
            "s_20_scans_256": wall_b, "prepared": out256}


def ingest(fold: str, native_on: bool) -> tuple[list, float]:
    """The eval fold's volumes through ``MedicalVolumeDataset`` (fold 0 at
    672) on the native feeder or on the numpy path: the images of its
    records and the ms a scan."""
    from unittest import mock

    import protosam_tpu_torch.native as native
    from protosam_tpu_torch.data.medical import MedicalVolumeDataset

    with mock.patch.object(native, "native_available",
                           native.native_available if native_on
                           else lambda: False):
        t0 = time.perf_counter()
        ds = MedicalVolumeDataset("CHAOST2", fold, 0, 672)
        ms = (time.perf_counter() - t0) / len(ds.pid_curr_load) * 1e3
    return [r.img for r in ds.actual_dataset], ms


def phase_native_eval(counters: dict, smi: str, tmp: str, fold: str,
                      eval_sps: float) -> dict:
    """10d: ``run_eval`` (7a's configuration) on phase 7's fold through the
    native feeder, every mask dumped (``tools.run_agreement.
    run_and_dump``), the native ingest held to the numpy ingest; 10e: the
    same with ``use_clahe=True``; 10f: ``tools.run_agreement`` against
    10d's masks."""
    import io
    import os

    from protosam_tpu_torch.data.clahe import clahe
    from protosam_tpu_torch.data.nifti import read_nii
    from protosam_tpu_torch.eval.protosam_eval import build_models, run_eval
    from protosam_tpu_torch.native import feeder
    from protosam_tpu_torch.tools import run_agreement

    numpy_imgs, numpy_ms = ingest(fold, False)
    native_imgs, native_ms = ingest(fold, True)
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(native_imgs, numpy_imgs))
    del numpy_imgs, native_imgs
    log(f"phase 10d ingest [{smi}]: native {native_ms:.1f} ms a scan, "
        f"numpy {numpy_ms:.1f} ms a scan ({FOLD_Z} x {FOLD_HW}² -> 672², "
        f"labels included); max abs gap {gap:.2e} (bound {INGEST_TOL:.0e})")
    if not gap <= INGEST_TOL:
        raise AssertionError("10d: native and numpy ingest disagree")

    cfg = eval_config(fold, "sam_b", log_dir=os.path.join(tmp, "log_10d"))
    pipe = build_models(cfg)
    dumped = os.path.join(tmp, "masks_10d")
    feeder.calls = 0
    res_d, launches_d, _ = counted_call(
        "phase 10d run_eval, native feeder",
        lambda: run_agreement.run_and_dump(cfg, dumped, pipe), counters,
        FLAGSHIP_KERNELS)
    log(f"phase 10d [{smi}]: run_eval {res_d['slices_per_sec']:.2f} "
        f"slices/s on the native feeder ({feeder.calls} feeder calls) "
        f"beside phase 7a's {eval_sps:.2f}; meanDice "
        f"{res_d['mar_val_batches_meanDice']:.5f}, {res_d['n_slices']} "
        f"masks dumped")
    if feeder.calls == 0:
        raise AssertionError("10d: run_eval did not take the native feeder")

    vol = read_nii(f"{fold}/image_1.nii.gz").astype(np.uint8)
    t0 = time.perf_counter()
    clahe(vol, 2.0)
    clahe_ms = (time.perf_counter() - t0) / len(vol) * 1e3
    calls = feeder.calls
    cfg_e = eval_config(fold, "sam_b", use_clahe=True)
    res_e, launches_e, _ = counted_call(
        "phase 10e run_eval, use_clahe=True",
        lambda: run_eval(cfg_e, pipe=pipe), counters, FLAGSHIP_KERNELS)
    log(f"phase 10e [{smi}]: run_eval {res_e['slices_per_sec']:.2f} "
        f"slices/s with CLAHE ({clahe_ms:.2f} ms a 256² slice on the host, "
        f"{feeder.calls - calls} feeder calls); meanDice "
        f"{res_e['mar_val_batches_meanDice']:.5f}")
    if feeder.calls != calls or res_e["n_slices"] != res_d["n_slices"]:
        raise AssertionError("10e: CLAHE took the native feeder, or another "
                             "slice count")
    del pipe

    argv = ["--ref-masks", dumped, *eval_argv(fold, "sam_b"),
            f"path.log_dir={os.path.join(tmp, 'log_10f')}"]
    buf = io.StringIO()
    rc, launches_f, _ = counted_call(
        "phase 10f run_agreement",
        lambda: _stdout_to(buf, run_agreement.main, argv), counters,
        FLAGSHIP_KERNELS)
    report = json.loads(buf.getvalue())
    log(f"phase 10f: run_agreement against 10d's masks: overall "
        f"{report['overall']} over {report['n_pairs']} masks, exit {rc}")
    if rc != 0 or report["overall"] != 1.0 \
            or report["n_pairs"] != res_d["n_slices"]:
        raise AssertionError(f"10f: agreement {report['overall']}, exit {rc}")
    return {"launches": {"10d": launches_d, "10e": launches_e,
                         "10f": launches_f},
            "native_ms_per_scan": native_ms, "numpy_ms_per_scan": numpy_ms,
            "ingest_gap": gap, "slices_per_sec": res_d["slices_per_sec"],
            "clahe_slices_per_sec": res_e["slices_per_sec"],
            "clahe_ms": clahe_ms, "agreement": report["overall"]}


def _stdout_to(buf, fn, *args):
    import contextlib

    with contextlib.redirect_stdout(buf):
        return fn(*args)


def phase_data(counters: dict, smi: str, tmp: str, fold: str,
               eval_sps: float) -> dict:
    """Phase 10: prepare (10a-10b), train on what was prepared (10c),
    evaluate through the native feeder (10d), with CLAHE (10e), agreement
    (10f)."""
    import os

    t0 = time.perf_counter()
    prep = phase_prepare(counters, smi, tmp, fold)
    cfg = train_config(prep["prepared"], os.path.join(tmp, "train_10c"),
                       modelname="dinov2_l14",
                       **{"input_size": "(672, 672)"})
    train = counted_train("phase 10c train dinov2_l14 672 on prepared "
                          "superpixels", cfg, counters, 3, TRAIN_KERNELS)
    step_ms = float(np.median(train["step_ms"][1:]))
    log(f"phase 10c [{smi}]: {step_ms:.1f} ms/step (median of steps 2-3), "
        f"kernel launches {train['launches']}, backward calls "
        f"{train['backward_calls']}")
    evals = phase_native_eval(counters, smi, tmp, fold, eval_sps)
    wall = time.perf_counter() - t0
    log(f"phase 10: {wall:.1f} s")
    launches = {**prep["launches"], "10c": train["launches"],
                **evals["launches"]}
    return {"launches": launches,
            "backward_calls_10c": train["backward_calls"],
            "train_step_ms": step_ms, "wall_s": wall,
            **{k: v for k, v in prep.items()
               if k not in ("launches", "prepared")},
            **{k: v for k, v in evals.items() if k != "launches"}}


# ---- phase 11: the polyp eval, multi-GPU, the launcher ---------------------

POLYP_HW = (576, 720)           # Kvasir's usual frame: non-square
POLYP_TRAIN, POLYP_TEST = 4, 16
PARALLEL_TOL = 1e-5             # dp scores; tp masks at mean Dice 0.99
PP_ABSENT = {0: ["relpos_patch_attention"],
             1: ["packed_masked_attention", "cca_label"]}


def write_polyp_fold(root: str, seed: int = 0) -> str:
    """A Kvasir-like fold written with the port's ``write_png``:
    ``Kvasir/{images,masks}`` and a ``split.txt`` of 4 train and 16 test
    RGB images at 576 x 720, smooth blobs with a brighter disc, the disc
    the mask.  Row r of every file takes PNG filter r % 5, so the decoder
    meets all five, as files of an adaptive encoder mix them."""
    import os

    from protosam_tpu_torch.data.png import write_png

    ds = os.path.join(root, "Kvasir")
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    h, w = POLYP_HW
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    filters = np.arange(h) % 5
    names = [f"kvasir_{i:02d}" for i in range(POLYP_TRAIN + POLYP_TEST)]
    for name in names:
        field = F.interpolate(torch.randn(1, 3, 12, 15, generator=g),
                              size=POLYP_HW, mode="bicubic",
                              align_corners=False)[0]
        cy, cx, r = (int(v) for v in (torch.randint(150, h - 150, (1,),
                                                    generator=g),
                                      torch.randint(150, w - 150, (1,),
                                                    generator=g),
                                      torch.randint(60, 140, (1,),
                                                    generator=g)))
        disc = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
        img = (field - field.min()) / (field.max() - field.min()) * 160
        img = img + 80 * disc
        write_png(os.path.join(ds, "images", name + ".png"),
                  img.clamp(0, 255).permute(1, 2, 0).to(torch.uint8).numpy(),
                  filters)
        write_png(os.path.join(ds, "masks", name + ".png"),
                  (disc * 255).to(torch.uint8).numpy(), filters)
    with open(os.path.join(ds, "split.txt"), "w") as f:
        f.write("train:\n" + "\n".join(names[:POLYP_TRAIN]) + "\nval:\n"
                "test:\n" + "\n".join(names[POLYP_TRAIN:]) + "\n")
    return root


def polyp_config(fold: str, sam_ver: str = "sam_b", **extra):
    """``run_protosam.sh polyp``'s settings (DINOv2-L/14 at 672, seed 42,
    cca), the SAM size given, bf16, on ``fold``."""
    from protosam_tpu_torch.utils.config import load_config

    argv = ["with", "modelname=dinov2_l14", "base_model=alpnet",
            "coarse_pred_only=False", f"protosam_sam_ver={sam_ver}",
            "curr_cls=polyps", "dataset=polyps", "proto_grid_size=8",
            "seed=42", "do_cca=True", "support_idx=[0]",
            "input_size=(672, 672)", f"path.polyps.data_dir={fold}",
            "dtype=bfloat16"]
    return load_config(argv + [f"{k}={v}" for k, v in extra.items()])


def phase_polyp_eval(counters: dict, smi: str, fold: str) -> dict:
    """11a: ``run_eval(dataset="polyps")`` at the flagship's width (SAM
    ViT-B) on the card, K1-K4 launched; then the tiny f32 pipeline's
    ``run_eval_polyp`` on the card against the CPU (metrics within 1e-6)."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.eval.protosam_eval import (build_models,
                                                       run_eval,
                                                       run_eval_polyp)
    from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig

    cfg = polyp_config(fold)
    pipe = build_models(cfg)
    res, launches, wall = counted_call(
        "phase 11a run_eval(dataset=polyps)",
        lambda: run_eval(cfg, pipe=pipe), counters, FLAGSHIP_KERNELS)
    del pipe
    log(f"phase 11a [{smi}]: run_eval polyps {res['slices_per_sec']:.2f} "
        f"slices/s ({res['n_slices']} test images of {POLYP_HW[0]} x "
        f"{POLYP_HW[1]} at the 672 frame, {wall:.1f} s with the support), "
        f"meanDice {res['mar_val_batches_meanDice']:.5f}, cases "
        f"{sorted(res['cases'])}")
    if res["n_slices"] != POLYP_TEST or not np.isfinite(
            res["mar_val_batches_meanDice"]):
        raise AssertionError(f"11a: {res}")

    tcfg = polyp_config(fold, input_size="(256, 256)")
    tiny = {}
    for dev in ("cuda", "cpu"):
        tpipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                               image_size=256, sam_size=256,
                               dtype=torch.float32,
                               config=ProtoSAMConfig(image_size=(256, 256),
                                                     max_ccs=4))
        tiny[dev] = run_eval_polyp(tcfg, tpipe)
    keys = [k for k in tiny["cpu"] if k.startswith("mar_")]
    gap = max([abs(tiny["cuda"][k] - tiny["cpu"][k]) for k in keys]
              + [abs(tiny["cuda"]["cases"][c]["meanDice"]
                     - tiny["cpu"]["cases"][c]["meanDice"])
                 for c in tiny["cpu"]["cases"]])
    log(f"phase 11a tiny f32 run_eval_polyp card vs CPU: max metric gap "
        f"{gap:.2e} (bound 1e-6); meanDice "
        f"{tiny['cuda']['mar_val_batches_meanDice']:.6f}")
    if not gap <= 1e-6:
        raise AssertionError("11a: the tiny polyp eval differs on the card")
    return {"launches": launches, "slices_per_sec": res["slices_per_sec"],
            "mean_dice": res["mar_val_batches_meanDice"], "tiny_gap": gap}


def phase_polyp_ssl(smi: str, fold: str) -> float:
    """11b: one ``SuperpixPolypDataset`` episode with ``get_polyp_transform``
    from a seeded generator, on the host."""
    from protosam_tpu_torch.data.polyp import SuperpixPolypDataset
    from protosam_tpu_torch.data.polyp_transforms import get_polyp_transform

    ds = SuperpixPolypDataset(
        fold, train=True, image_size=672, seed=0,
        transforms=get_polyp_transform(np.random.RandomState(0))[0])
    t0 = time.perf_counter()
    ep = ds[0]
    ms = (time.perf_counter() - t0) * 1e3
    sup, qry = ep["support_images"][0][0], ep["query_images"][0]
    fg = ep["support_mask"][0][0]["fg_mask"]
    log(f"phase 11b [{smi}]: SuperpixPolypDataset episode {ms:.1f} ms on "
        f"the host (PNG read, Felzenszwalb, two draws of the transforms); "
        f"superpixel {ep['superpix_label']}, support fg share "
        f"{float(fg.mean()):.4f}")
    if sup.shape != (3, 672, 672) or qry.shape != (3, 672, 672) \
            or not np.isfinite(sup).all() or not 0 < fg.sum():
        raise AssertionError("11b: a malformed episode")
    return ms


def phase_parallel(smi: str) -> dict:
    """11c: dp, tp and pp on two ranks that share the one card, gloo (NCCL
    refuses two ranks on one device); the code's default on cards stays
    NCCL.  dp masks bit-equal to ``forward_volume``'s (scores 1e-5), tp
    masks at mean Dice >= 0.99, pp masks equal; K1-K4 in every dp and tp
    rank, and across pp's two stages.  Then the dp tool's overhead."""
    from protosam_tpu_torch.tools import measure_dp_scaling as dps

    t0 = time.perf_counter()
    rows = dps.check_paths("flagship", 2, N_SLICES, backend="gloo")
    log(f"phase 11c: backend {rows[0]['backend']} (all_reduce and "
        f"all_gather take the CUDA tensors; send/recv staged through the "
        f"host, by the backend's name)")
    launches = {}
    for row in rows:
        r = row["rank"]
        if not row["dp_bit_equal"] or not row["dp_score_gap"] <= PARALLEL_TOL:
            raise AssertionError(f"11c rank {r}: dp differs")
        if not row["tp_mean_dice"] >= 0.99:
            raise AssertionError(f"11c rank {r}: tp masks at mean Dice "
                                 f"{row['tp_mean_dice']}")
        if not row["pp_equal"]:
            raise AssertionError(f"11c rank {r}: pp masks differ")
        for mode in ("dp", "tp", "pp"):
            launches[f"11c {mode} rank {r}"] = row["launches"][mode]
            missing = [k for k in FLAGSHIP_KERNELS
                       if row["launches"][mode][k] == 0]
            # pp: stage A (rank 0) runs no SAM (K4), stage B no DINOv2 (K2)
            # and no prompt extraction (K3)
            absent = PP_ABSENT[r] if mode == "pp" else []
            if sorted(missing) != sorted(absent):
                raise AssertionError(f"11c rank {r} {mode}: kernels never "
                                     f"launched: {missing}")
    scaling = dps.run("flagship", 2, N_SLICES, reps=1, backend="gloo")
    if scaling["collectives_before_gather"] or not scaling[
            "dp_bit_equal_to_forward_volume"]:
        raise AssertionError(f"11c: the dp tool found {scaling}")
    wall = time.perf_counter() - t0
    log(f"phase 11c [{smi}]: dp overhead {scaling['dp_program_overhead']:+.4f}"
        f" (2 ranks on one card, gloo; single rank "
        f"{scaling['t_single_rank_ms']:.1f} ms, dp "
        f"{scaling['t_dp_same_work_ms']:.1f} ms for {N_SLICES} slices); "
        f"{wall:.1f} s")
    return {"launches": launches, "dp_overhead": scaling["dp_program_overhead"],
            "t_single_rank_ms": scaling["t_single_rank_ms"],
            "t_dp_ms": scaling["t_dp_same_work_ms"]}


def phase_launcher(smi: str, tmp: str, fold: str) -> float:
    """11d: ``protosam_tpu_torch/run_protosam.sh polyp`` with its defaults
    (SAM ViT-H), run from a directory whose ``data/polyps`` is 11a's fold;
    it must exit 0 and print its result."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "launch_11d")
    os.makedirs(os.path.join(work, "data"))
    os.symlink(fold, os.path.join(work, "data", "polyps"))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    out = subprocess.run(
        ["bash", os.path.join(repo, "protosam_tpu_torch", "run_protosam.sh"),
         "polyp"], cwd=work, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    tail = out.stdout.strip()
    if out.returncode != 0:
        raise AssertionError(f"11d: run_protosam.sh polyp exited "
                             f"{out.returncode}:\n{out.stderr[-3000:]}")
    result = json.loads(tail[tail.index("{"):])
    log(f"phase 11d [{smi}]: run_protosam.sh polyp (SAM ViT-H) exit 0 in "
        f"{wall:.1f} s: {result}")
    if result["n_slices"] != POLYP_TEST:
        raise AssertionError(f"11d: {result}")
    return wall


def phase_polyp_parallel(counters: dict, smi: str, tmp: str) -> dict:
    """Phase 11: 11a-11b on a Kvasir-like fold, 11c multi-GPU, 11d the
    launcher."""
    import os

    t0 = time.perf_counter()
    fold = write_polyp_fold(os.path.join(tmp, "polyps"))
    evals = phase_polyp_eval(counters, smi, fold)
    ssl_ms = phase_polyp_ssl(smi, fold)
    par = phase_parallel(smi)
    launcher_s = phase_launcher(smi, tmp, fold)
    wall = time.perf_counter() - t0
    log(f"phase 11: {wall:.1f} s")
    return {"launches": {"11a": evals["launches"], **par["launches"]},
            "polyp_slices_per_sec": evals["slices_per_sec"],
            "polyp_mean_dice": evals["mean_dice"], "ssl_episode_ms": ssl_ms,
            "dp_overhead": par["dp_overhead"],
            "launcher_s": launcher_s, "wall_s": wall}


def make_counters() -> dict:
    """kernel -> (its wrapper, the wrapper's count of its launches)"""
    from protosam_tpu_torch.ops.alp import alp_match_fused
    from protosam_tpu_torch.ops.attention import \
        masked_flash_attention_packed
    from protosam_tpu_torch.ops.cca import label_components
    from protosam_tpu_torch.ops.mlp import dense_residual, mlp_fused
    from protosam_tpu_torch.ops.norm import layer_norm_rows
    from protosam_tpu_torch.ops.quant import (int8_matmul_dequant,
                                              quantize_rows)
    from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention

    return {
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


def main() -> int:
    counters = make_counters()
    smi = phase_device()
    phase_build()
    checks = phase_kernels()
    phase_wiring()
    flagship, bf16_preds, bf16_walls = phase_flagship(counters)
    int8 = phase_flagship_int8(counters, bf16_preds, bf16_walls)
    del bf16_preds
    launches = phase_vith(counters)
    tools = phase_tools(counters)
    with tempfile.TemporaryDirectory() as tmp:
        eval_launches, fold, eval_sps = phase_eval(counters, smi, tmp)
        train = phase_train(counters, smi, tmp, fold)
        alpnet = phase_alpnet_eval(counters, smi, fold)
        sam_tools = phase_sam_tools(counters, smi, tmp)
        data = phase_data(counters, smi, tmp, fold, eval_sps)
        polyp = phase_polyp_parallel(counters, smi, tmp)
    log(json.dumps(kernel_report(checks, launches, flagship, int8, tools,
                                 eval_launches, train, alpnet, sam_tools,
                                 data, polyp)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
