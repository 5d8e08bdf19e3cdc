"""Parity of the PyTorch port's ops with the JAX package, and of its CUDA
kernels with their plain versions.

The same numpy-seeded arrays go to the JAX function (the Pallas kernels in
interpret mode, as their own tests run them) and to the port on the CPU,
where each kernel wrapper takes its plain PyTorch version.  Tests marked
``cuda`` compare the hand-written kernels with those plain versions and skip
without a GPU.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from protosam_tpu.ops import attention as jattn
    from protosam_tpu.ops import norm as jnorm
    from protosam_tpu.ops import pooling as jpool
    from protosam_tpu.ops import resize as jresize
    from protosam_tpu.ops import vitdet_flash as jvf
    from protosam_tpu.ops.morphology import dilate as jdilate
except ImportError:
    pass

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.ops import alp as talp
from protosam_tpu_torch.ops import attention as tattn
from protosam_tpu_torch.ops import mlp as tmlp
from protosam_tpu_torch.ops import norm as tnorm
from protosam_tpu_torch.ops import pooling as tpool
from protosam_tpu_torch.ops import resize as tresize
from protosam_tpu_torch.ops import vitdet_flash as tvf
from protosam_tpu_torch.ops.morphology import dilate as tdilate
from protosam_tpu_torch.tools import bench_attn, bench_dino_flash

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()  # f32 tests compare in full f32: no TF32 anywhere
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- norms


@pytest.mark.parametrize("shape", [
    (7, 48), (2, 5, 64), (16, 160),
    (16, 768), (8, 1024), (24, 1280),  # SAM-B, DINOv2-L and SAM-H widths
])
def test_layer_norm_matches_jax_kernel(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    n = int(np.prod(shape[:-1]))
    if n % 8:  # the Pallas kernel needs an 8-row multiple: the CPU lowering
        want = np.asarray(jnorm.layer_norm_tokens(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))).reshape(n, c)
    else:
        want = np.asarray(jnorm._ln_pallas(
            jnp.asarray(x.reshape(n, c)), jnp.asarray(w), jnp.asarray(b),
            1e-6, jnp.float32, interpret=True))
    got = tnorm.layer_norm_tokens(t(x), t(w), t(b), 1e-6).numpy()
    np.testing.assert_allclose(got.reshape(n, c), want, **TOL)


def test_safe_norm_and_cosine_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 5, 5)).astype(np.float32)
    y = rng.standard_normal((3, 16, 5, 5)).astype(np.float32)
    x[0, :, 0, 0] = 0.0  # the eps clamp
    np.testing.assert_allclose(
        tnorm.safe_l2_normalize(t(x), dim=1).numpy(),
        np.asarray(jnorm.safe_l2_normalize(jnp.asarray(x), axis=1)), **TOL)
    np.testing.assert_allclose(
        tnorm.cosine_similarity(t(x), t(y), dim=1).numpy(),
        np.asarray(jnorm.cosine_similarity(jnp.asarray(x), jnp.asarray(y),
                                           axis=1)), **TOL)


# ------------------------------------------------------------ attention


def _packed_qkv(rng, b, s, nh, hd):
    return rng.standard_normal((b, s, 3 * nh * hd)).astype(np.float32)


@pytest.mark.parametrize("nh,hd,s,n_valid", [
    (2, 32, 96, None), (4, 40, 80, 70), (2, 32, 128, 100)])
def test_packed_attention_matches_jax_kernel(nh, hd, s, n_valid):
    rng = np.random.default_rng(2)
    qkv = _packed_qkv(rng, 2, s, nh, hd)
    scale = hd ** -0.5
    want = np.asarray(jattn.masked_flash_attention_packed(
        jnp.asarray(qkv), scale=scale, num_heads=nh, n_valid=n_valid,
        interpret=True))
    got = tattn.masked_flash_attention_packed(
        t(qkv), scale=scale, num_heads=nh, n_valid=n_valid).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_packed_attention_dinov2_padded_sequence():
    """S >= 2048: the DINOv2 pad-and-mask geometry (2050 tokens padded once
    to a 128 multiple, keys >= 2050 masked)."""
    rng = np.random.default_rng(3)
    n_tokens = 2050
    s = n_tokens + (-n_tokens) % 128
    qkv = _packed_qkv(rng, 1, s, 2, 32)
    kw = dict(scale=32 ** -0.5, num_heads=2, n_valid=n_tokens)
    want = np.asarray(jattn.masked_flash_attention_packed(
        jnp.asarray(qkv), interpret=True, **kw))
    got = tattn.masked_flash_attention_packed(t(qkv), **kw).numpy()
    np.testing.assert_allclose(got[:, :n_tokens], want[:, :n_tokens], **TOL)


def _relpos_inputs(rng, side, patch, nh, hd):
    qkv = rng.standard_normal((1, side, side, 3 * nh * hd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(
        (1, side, side, nh * 2 * patch))).astype(np.float32)
    return qkv, bias


def test_window_attention_matches_jax_kernel_70_grid():
    """SAM's windowed geometry: a 64² grid padded to 70², 14×14 windows."""
    rng = np.random.default_rng(4)
    qkv, bias = _relpos_inputs(rng, 70, 14, 2, 16)
    want = np.asarray(jvf.window_packed_attention(
        jnp.asarray(qkv), jnp.asarray(bias), 14, 2, 0.25, interpret=True,
        flat=True))
    got = tvf.window_packed_attention(t(qkv), t(bias), 14, 2, 0.25).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_global_attention_matches_jax_kernel_64_grid():
    rng = np.random.default_rng(5)
    qkv, bias = _relpos_inputs(rng, 64, 64, 2, 16)
    want = np.asarray(jvf.global_packed_attention(
        jnp.asarray(qkv), jnp.asarray(bias), 2, 0.25, rows_per_blk=16,
        interpret=True))
    got = tvf.global_packed_attention(t(qkv), t(bias), 2, 0.25).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("side,patch", [(28, 14), (16, 16)])
def test_relpos_attention_matches_jax_kernel_at_score_spread_4(side, patch):
    """The windowed 28² grid (P = 14) and the global 16² grid on
    ``bench_attn.check_bias``'s inputs: q·k·scale and each bias factor of
    σ ≈ 2, where a misplaced bias term shows."""
    qkv, bias = bench_attn.bias_check_inputs(1, side, patch, 2, 16, seed=11)
    scale = 16 ** -0.5
    if patch == side:
        want = jvf.global_packed_attention(
            jnp.asarray(qkv), jnp.asarray(bias), 2, scale, rows_per_blk=8,
            interpret=True)
    else:
        want = jvf.window_packed_attention(
            jnp.asarray(qkv), jnp.asarray(bias), patch, 2, scale,
            interpret=True, flat=True)
    got = tvf.relpos_patch_attention(t(qkv), t(bias), patch, 2, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("side,patch", [(28, 14), (16, 16)])
def test_check_bias_control_fails_the_bf16_bound(side, patch, monkeypatch):
    """On the CPU the wrapper is the plain version, so ``check_bias`` holds
    its bf16 run against its f32 run; the swapped-bias control must land
    beyond the bf16 bound, and a kernel that swapped the two bias factors
    must fail the check."""
    qkv, bias = (torch.from_numpy(x).to(torch.bfloat16) for x in
                 bench_attn.bias_check_inputs(1, side, patch, 2, 16))
    scale = 16 ** -0.5
    out = bench_attn.check_bias(qkv, bias, patch, 2, scale)
    assert out["swap_max_err"] > 10 * out["bound"]
    assert out["mean_err"] <= bench_attn.BIAS_SHARE * out["swap_mean_gap"]
    monkeypatch.setattr(
        bench_attn, "relpos_patch_attention",
        lambda q, b, p, nh, sc: tvf.relpos_patch_attention_plain(
            q, bench_attn.swap_bias(b, p, nh), p, nh, sc))
    with pytest.raises(AssertionError, match="misreads"):
        bench_attn.check_bias(qkv, bias, patch, 2, scale)


def test_check_mask_control_fails_the_bf16_bound(monkeypatch):
    """On the CPU the wrapper is the plain version, so ``check_mask`` holds
    its bf16 run against its f32 run; the unmasked control must land beyond
    the bf16 bound, and a kernel that let the keys past n_valid in must
    fail the check."""
    kw = dict(scale=64 ** -0.5, num_heads=2, n_valid=100)
    qkv = torch.from_numpy(bench_dino_flash.mask_check_inputs(
        1, 130, 2, 64, 100)).to(torch.bfloat16)
    out = bench_dino_flash.check_mask(qkv, **kw)
    assert out["control_max_err"] > 10 * out["bound"]
    monkeypatch.setattr(
        bench_dino_flash, "masked_flash_attention_packed",
        lambda q, n_valid, **k: tattn.masked_attention_packed_plain(q, **k))
    with pytest.raises(AssertionError, match="past n_valid"):
        bench_dino_flash.check_mask(qkv, **kw)


# --------------------------------------------------- resize and pooling


@pytest.mark.parametrize("src,dst", [((9, 9), (32, 32)), ((48, 40), (17, 23)),
                                     ((21, 21), (126, 126))])
def test_resize_bilinear_and_nearest_match_jax(src, dst):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, *src)).astype(np.float32)
    np.testing.assert_allclose(
        tresize.resize_bilinear(t(x), dst).numpy(),
        np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst)), **TOL)
    np.testing.assert_array_equal(
        tresize.resize_nearest(t(x), dst).numpy(),
        np.asarray(jresize.resize_nearest(jnp.asarray(x), dst)))


@pytest.mark.parametrize("size", [(126, 126), (100, 90), (256, 256)])
def test_resize_bilinear_then_nearest_matches_jax(size):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    got = tresize.resize_bilinear_then_nearest(t(x), (256, 256), size)
    want = jresize.resize_bilinear_then_nearest(jnp.asarray(x), (256, 256),
                                                size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scales,antialias", [
    (None, False), ((37 / 9.1, 37 / 9.1), False), (None, True)])
def test_resize_bicubic_torch_matches_jax(scales, antialias):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 16, 37, 37)).astype(np.float32)
    got = tresize.resize_bicubic_torch(t(x), (9, 9), scales, antialias)
    want = jresize.resize_bicubic_torch(jnp.asarray(x), (9, 9), scales,
                                        antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_avg_pool_and_dilate_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 4, 12, 10)).astype(np.float32)
    np.testing.assert_allclose(tpool.avg_pool2d(t(x), 2).numpy(),
                               np.asarray(jpool.avg_pool2d(jnp.asarray(x),
                                                           2)), **TOL)
    m = (rng.random((3, 40, 40)) > 0.97).astype(np.float32)
    np.testing.assert_array_equal(
        tdilate(t(m), 3, 10).numpy(), np.asarray(jdilate(jnp.asarray(m), 3,
                                                         10)))


# ------------------------------------------------------------ package


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib, protosam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'protosam_tpu', 'cv2', 'pandas', "
        "'SimpleITK', 'nibabel')]\n"
        "print(len(bad)); assert not bad, bad\n"
        "for m in ('ops.mlp', 'ops.alp', 'eval.protosam_eval', "
        "'utils.config', 'data.medical', 'data.nifti', 'utils.checkpoint', "
        "'utils.detection', 'pipeline.protomedsam', 'ops.rotate', "
        "'validation_protosam', 'train.step', 'train.trainer', "
        "'train.lora', 'eval.alpnet_eval', 'eval.ttt', 'data.transforms', "
        "'data.superpixel', 'models.backbones.resnet', 'models.master', "
        "'training', 'validation', 'models.sam.rle', 'models.sam.amg', "
        "'models.sam.predictor', 'models.samwrapper', 'serve', "
        "'utils.export', 'data.prefetch', 'utils.agreement', "
        "'utils.debugging', 'utils.legacy', 'tools.replay_goldens'):\n"
        "    assert 'protosam_tpu_torch.' + m in sys.modules, m\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


def test_wrappers_take_plain_versions_on_cpu():
    """A CPU tensor takes the plain version and counts no launch."""
    wrappers = (tnorm.layer_norm_rows, tattn.masked_flash_attention_packed,
                tvf.relpos_patch_attention, talp.alp_match_fused,
                tmlp.dense_residual, tmlp.mlp_fused)
    before = [fn.launches for fn in wrappers]
    tnorm.layer_norm_rows(torch.ones(8, 4), torch.ones(4), torch.zeros(4))
    tattn.masked_flash_attention_packed(torch.ones(1, 4, 6), scale=1.0,
                                        num_heads=1)
    tvf.relpos_patch_attention(torch.ones(1, 2, 2, 6), torch.ones(1, 2, 2, 4),
                               2, 1, 1.0)
    talp.alp_match_fused(torch.ones(1, 4, 2, 2), torch.ones(3, 4),
                         torch.ones(3, dtype=torch.bool))
    x, w = torch.ones(4, 16, dtype=torch.bfloat16), torch.ones(
        16, 16, dtype=torch.bfloat16)
    b = torch.zeros(16, dtype=torch.bfloat16)
    tmlp.dense_residual(x, w, b, x)
    tmlp.mlp_fused(x, w, b, w, b, x)
    assert before == [fn.launches for fn in wrappers]


# -------------------------------------------------------- CUDA kernels


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [
    768, 1024, 1280,  # the vector kernel: 3-5 (bf16), 6-10 (f32) a lane
    160,              # one vector a lane, lanes past C / 8 (C / 4) idle
    100,              # bf16 C % 8 != 0: the scalar kernel (f32: vectors)
    2600,             # wider than 10 vectors a lane: the scalar kernel
])
# 300: not a multiple of the 8 rows a block; 4864, DINOv2-L's rows at B = 2,
# where f32 at C = 1024 takes the scalar kernel by its waves on an H100
@pytest.mark.parametrize("rows", [300, 4864])
def test_layer_norm_kernel_matches_plain(cuda, dtype, c, out_dtype, rows):
    """The f32 plain version on the same input, to 1e-4 and, for a bf16
    output, half a bf16 ulp more."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(rows, c, generator=g) * 3 + 1).to(cuda, dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    b = (0.1 * torch.randn(c, generator=g)).to(cuda)
    before = tnorm.layer_norm_rows.launches
    got = tnorm.layer_norm_rows(x, w, b, 1e-6, out_dtype)
    assert tnorm.layer_norm_rows.launches == before + 1
    assert got.dtype == out_dtype
    want = tnorm.layer_norm_rows_plain(x, w, b, 1e-6, torch.float32)
    rtol = 1e-4 if out_dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,hd,s,n_valid", [
    (2, 32, 130, 100), (4, 40, 82, None), (2, 64, 256, 200),
    (4, 80, 200, 150),    # hd 80: two 64-column panels (DP = 128)
    (2, 64, 256, 192),    # n_valid a multiple of the 64-key tile
    (2, 64, 130, 1),      # one valid key
    (2, 72, 70, 70),      # S < 64: the second warpgroup's rows all past S
    (16, 64, 2432, 2305)])  # DINOv2-L at 672 px (at B = 1)
def test_packed_attention_kernel_matches_plain(cuda, dtype, nh, hd, s,
                                               n_valid):
    g = torch.Generator().manual_seed(1)
    b = 1 if s == 2432 else 2
    qkv = torch.randn(b, s, 3 * nh * hd, generator=g).to(cuda, dtype)
    kw = dict(scale=hd ** -0.5, num_heads=nh, n_valid=n_valid)
    got = tattn.masked_flash_attention_packed(qkv, **kw).float()
    want = tattn.masked_attention_packed_plain(qkv.float(), **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,hd,n_valid", [
    (2, 130, 2, 64, 100), (1, 200, 4, 80, 150), (1, 82, 4, 40, 64),
    (2, 2432, 16, 64, 2305)])  # DINOv2-L at 672 px
def test_packed_attention_kernel_masks_the_keys_past_n_valid(cuda, b, s, nh,
                                                             hd, n_valid):
    """``bench_dino_flash.check_mask``: the keys and values past n_valid 8
    times larger; K2 within the bf16 bound, the unmasked control beyond it
    (it raises otherwise)."""
    qkv = torch.from_numpy(bench_dino_flash.mask_check_inputs(
        b, s, nh, hd, n_valid)).to(cuda, torch.bfloat16)
    bench_dino_flash.check_mask(qkv, scale=hd ** -0.5, num_heads=nh,
                                n_valid=n_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,patch,nh,hd", [
    (28, 14, 4, 40), (16, 16, 4, 40), (70, 14, 4, 64),
    (28, 14, 16, 80), (16, 16, 16, 80),  # hd 80, 16 heads: SAM ViT-H
    # the main path's shapes: global ViT-B and ViT-H (at B = 1), and the
    # ViT-H windowed grid, whose last key tile holds 4 of 64 keys
    (64, 64, 12, 64), (64, 64, 16, 80), (70, 14, 16, 80)])
def test_relpos_kernel_matches_plain(cuda, dtype, side, patch, nh, hd):
    g = torch.Generator().manual_seed(2)
    b = 1 if side == patch == 64 else 2
    qkv = torch.randn(b, side, side, 3 * nh * hd, generator=g).to(cuda,
                                                                  dtype)
    bias = (0.5 * torch.randn(b, side, side, nh * 2 * patch,
                              generator=g)).to(cuda, dtype)
    got = tvf.relpos_patch_attention(qkv, bias, patch, nh, 0.2).float()
    want = tvf.relpos_patch_attention_plain(qkv.float(), bias.float(), patch,
                                            nh, 0.2)
    # f32: exact FMAs; bf16: 2e-2, within tools.timing's bf16 bound
    # 2e-2 x max(1, max|ref|)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("side,patch,nh,hd", [(70, 14, 16, 80),
                                              (64, 64, 12, 64)])
def test_relpos_kernel_reads_the_bias_right(cuda, side, patch, nh, hd):
    """``bench_attn.check_bias`` at scores spread ~4: within a quarter of
    the swapped-bias gap, while the swapped control fails (it raises
    otherwise)."""
    qkv, bias = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
                 bench_attn.bias_check_inputs(1, side, patch, nh, hd))
    bench_attn.check_bias(qkv, bias, patch, nh, hd ** -0.5)
