"""The port's measurement tools (``protosam_tpu_torch/tools/``) against the
JAX package's ``tools/``, and their CPU-side logic.

The same numpy-seeded arrays go to the JAX tool's Pallas kernels (in
interpret mode, each wrapped in its own ``pl.pallas_call`` at a small
shape) and to the port on the CPU, where each kernel wrapper takes its
plain version: row 13 (``bench_fc2.pallas_fc2``) and row 14
(``microbench_attn``'s v0-v3) of the kernel table.  ``tools/`` has no
``__init__.py``, so its modules are loaded by file path.  The rest checks
the roofline's counts, the stage timer, the trace summary and the
instrumentation here, and that every tool refuses to run without a card.
Tests marked ``cuda`` run the kernels at the tools' geometries on the card.
"""

import functools
import importlib
import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
except ImportError:
    pass

from protosam_tpu_torch.entry import build_pipeline, set_f32_precision
from protosam_tpu_torch.ops import attention as tattn
from protosam_tpu_torch.ops.mlp import dense_residual, dense_residual_plain
from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention_plain
from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
from protosam_tpu_torch.tools import (bench_attn, bench_cca, bench_fc2,
                                      microbench_attn, pipeline_profile,
                                      ptxas_report, roofline, trace_volume)
from protosam_tpu_torch.utils.profiling import StageTimer
from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                synthetic_episode)

torch.set_num_threads(2)

BF16_TOL = 2e-2  # x max(1, max|ref|)
REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ("bench_fc2", "microbench_attn", "bench_attn", "bench_dino_flash",
         "bench_cca", "bench_mlp_kernel", "bench_dino_encoder",
         "bench_sam_encoder", "pipeline_profile", "trace_volume",
         "roofline", "ptxas_report", "microbench_int8",
         "measure_int8_drift")


@functools.cache
def jax_tool(name: str):
    """``tools/<name>.py`` of the JAX package, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()
    return torch.device("cuda")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")


def bf16_bound(ref) -> float:
    return BF16_TOL * max(1.0, float(np.abs(ref).max()))


# ------------------------------------------------------ row 13: bench_fc2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fc2_matches_pallas_fc2(dtype):
    """K6's CPU path at a small fc2 geometry against the JAX tool's blocked
    Pallas GEMM (interpret mode), on the tool's seeded inputs."""
    m, k, n = 256, 512, 256
    tdt = getattr(torch, dtype)
    x, w, b, r = bench_fc2.to_kernel_layout(
        *bench_fc2.fc2_inputs(m, k, n), "cpu", tdt)
    got = dense_residual(x, w, b, r).float().numpy()
    # the JAX tool's layout: w (K, N), b (1, N), the same rounded values
    j = lambda a: jnp.asarray(a.float().numpy(), getattr(jnp, dtype))
    want = np.asarray(jax_tool("bench_fc2").pallas_fc2(
        j(x), j(w.T.contiguous()), j(b[None]), j(r), bm=128, bk=256, bn=128,
        interpret=True).astype(jnp.float32))
    tol = bf16_bound(want) if dtype == "bfloat16" else 1e-5
    assert np.abs(got - want).max() <= tol


# ---------------------------------------------- row 14: microbench_attn


def _jax_variant(variant: str, qkv, *, nh, hd, n_valid):
    """The JAX tool's kernel of ``variant`` in its own ``pallas_call`` at
    the shape of ``qkv`` (interpret mode)."""
    mb = jax_tool("microbench_attn")
    b, s, c3 = qkv.shape
    c = c3 // 3
    kw = dict(scale=hd ** -0.5, n_valid=n_valid, nh=nh, hd=hd)
    scratch = []
    if variant == "v0":
        kern = functools.partial(mb._v0_kernel, **kw)
    elif variant == "v1":
        kern = functools.partial(mb._v1_kernel, **kw)
        scratch = [mb.pltpu.VMEM((s, hd + 1), qkv.dtype)]
    else:
        sdt = jnp.bfloat16 if variant == "v3" else jnp.float32
        kern = functools.partial(mb._v2_kernel, **kw, score_dtype=sdt)
        scratch = [mb.pltpu.VMEM((s, hd + 1), qkv.dtype)] * 3
    return pl.pallas_call(
        kern, grid=(b,),
        in_specs=[pl.BlockSpec((1, s, c3), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, s, c), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, s, c), qkv.dtype),
        scratch_shapes=scratch, interpret=True)(qkv)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _attention_case(variant, logit_scale=1.0):
    """(the port's plain f32-score and bf16-score outputs, the JAX tool's
    ``variant``) at B = 2, S = 256, 2 heads × 64, n_valid 200 on the tool's
    input times ``logit_scale``."""
    b, s, nh, hd, n_valid = 2, 256, 2, 64, 200
    qkv = torch.from_numpy(microbench_attn.qkv_input(b, s, nh * hd)
                           * logit_scale).to(torch.bfloat16)
    plain = {dt: tattn.masked_attention_packed_plain(
        qkv, scale=hd ** -0.5, num_heads=nh, n_valid=n_valid,
        score_dtype=dt).float().numpy()
        for dt in (torch.float32, torch.bfloat16)}
    want = np.asarray(_jax_variant(
        variant, jnp.asarray(qkv.float().numpy(), jnp.bfloat16), nh=nh,
        hd=hd, n_valid=n_valid).astype(jnp.float32))
    return plain[torch.float32], plain[torch.bfloat16], want


def _assert_v3_not_v0(v0, v3, want):
    """v3 within one bf16 ulp of the JAX v3 everywhere; the f32-score v0
    beyond that on more than a tenth of the elements."""
    ulp = lambda got: bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(v3 - want) <= ulp(v3)).all()
    assert (np.abs(v0 - want) > ulp(v0)).mean() > 0.1


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3"])
def test_attention_plain_matches_microbench_variants(variant):
    """The port's plain version (f32 scores for v0-v2, bf16 scores for v3)
    against the JAX tool's kernels: v0-v2 within the bf16 bound, v3 within
    one bf16 ulp, where the f32-score version is not."""
    v0, v3, want = _attention_case(variant)
    if variant == "v3":
        _assert_v3_not_v0(v0, v3, want)
    else:
        assert np.abs(v0 - want).max() <= bf16_bound(want)


def test_attention_plain_v3_at_large_logits():
    """At scores spread ~4 (the tool's input x 4), where rounding a score to
    bf16 moves its weight by percent, the plain v3 still sits within one
    bf16 ulp of the JAX v3 and the f32-score version does not."""
    _assert_v3_not_v0(*_attention_case("v3", microbench_attn.LOGIT_SCALE))


def test_bf16_scores_on_cpu_take_the_plain_version_and_refuse_f32():
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((1, 64, 3 * 32))).to(
        torch.bfloat16)
    kw = dict(scale=0.25, num_heads=2, n_valid=50)
    assert torch.equal(
        tattn.masked_flash_attention_packed(qkv, score_dtype=torch.bfloat16,
                                            **kw),
        tattn.masked_attention_packed_plain(qkv, score_dtype=torch.bfloat16,
                                            **kw))
    with pytest.raises(TypeError):
        tattn.masked_flash_attention_packed(
            qkv.float(), score_dtype=torch.bfloat16, **kw)


def test_microbench_sdpa_yardstick_is_the_masked_function():
    """SDPA on head-split views with keys sliced to n_valid computes K2's
    function (f32 on the CPU)."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3 * 24))).float()
    kw = dict(scale=0.3, num_heads=3, n_valid=33)
    torch.testing.assert_close(
        microbench_attn.sdpa(qkv, **kw),
        tattn.masked_attention_packed_plain(qkv, **kw), atol=1e-5,
        rtol=1e-5)


def test_bench_attn_sdpa_yardstick_is_relpos_attention():
    """SDPA over window-partitioned q/k/v with the expanded additive bias
    computes K4's function (f32 on the CPU)."""
    rng = np.random.default_rng(3)
    b, side, patch, nh, hd = 2, 8, 4, 2, 8
    qkv = torch.from_numpy(rng.standard_normal(
        (b, side, side, 3 * nh * hd))).float()
    bias = torch.from_numpy(rng.standard_normal(
        (b, side, side, nh * 2 * patch))).float()
    scale = hd ** -0.5
    ops = bench_attn.sdpa_operands(qkv, bias, patch, nh)
    torch.testing.assert_close(
        bench_attn.sdpa_patches(*ops, scale, b, side, patch),
        relpos_patch_attention_plain(qkv, bias, patch, nh, scale),
        atol=1e-5, rtol=1e-5)


def test_bench_cca_masks_are_the_jax_tools():
    np.testing.assert_array_equal(
        bench_cca.make_masks(4, side=64, seed=3),
        jax_tool("bench_cca").make_masks(4, side=64, seed=3))


# ------------------------------------------------------------- roofline


@pytest.mark.parametrize("model", ["dinov2_l14", "vit_b", "vit_h"])
def test_roofline_dense_counts_match_jax(model):
    jr = jax_tool("roofline")
    if model.startswith("dinov2"):
        ours, theirs = (r.dino_flops(model, 672)["dinov2 dense gemms"]
                        for r in (roofline, jr))
    else:
        ours, theirs = (r.sam_flops(model)["sam dense gemms"]
                        for r in (roofline, jr))
    assert ours == theirs


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# (kernel, shapes, flops, bytes, peak), each computed by hand
_HAND = {
    "K7": ("mlp_fused", dict(m=8192, c=1280, h=5120),
           4 * 8192 * 1280 * 5120,
           2 * (3 * 8192 * 1280 + 2 * 5120 * 1280 + 5120 + 1280), 989e12),
    "K6": ("dense_residual", dict(m=8192, k=1280, n=1280),
           2 * 8192 * 1280 * 1280,
           2 * (8192 * 1280 + 1280 * 1280 + 1280 + 2 * 8192 * 1280), 989e12),
    "row13": ("dense_residual", dict(m=39200, k=5120, n=1280),
              2 * 39200 * 5120 * 1280,
              2 * (39200 * 5120 + 1280 * 5120 + 1280 + 2 * 39200 * 1280),
              989e12),
    "K2": ("packed_masked_attention",
           dict(b=2, s=2432, nh=16, hd=64, n_valid=2305),
           4 * 2 * 16 * 2432 * 2305 * 64, 2 * 2432 * 4096 * 2, 989e12),
    "row14": ("packed_masked_attention",
              dict(b=8, s=2432, nh=16, hd=64, n_valid=2305),
              4 * 8 * 16 * 2432 * 2305 * 64, 8 * 2432 * 4096 * 2, 989e12),
    "K4 global": ("relpos_patch_attention",
                  dict(b=2, hp=64, wp=64, nh=16, hd=80, patch=64),
                  4 * 2 * 4096 ** 2 * 80 * 16,
                  2 * 4096 * (3 * 1280 + 16 * 128 + 1280) * 2, 989e12),
    "K4 window": ("relpos_patch_attention",
                  dict(b=2, hp=70, wp=70, nh=16, hd=80, patch=14),
                  4 * 2 * 25 * 196 ** 2 * 80 * 16,
                  2 * 4900 * (3 * 1280 + 16 * 28 + 1280) * 2, 989e12),
    "K5": ("alp_match", dict(n=4, c=1024, hw=2304, p=577),
           2 * 4 * 2304 * 577 * 1024,
           (4 * 1024 * 2304 + 577 * 1024 + 4 * 2304) * 4 + 577, 67e12),
    "K1": ("layer_norm_rows", dict(rows=4864, c=1024),
           8 * 4864 * 1024, 4864 * 1024 * 4 + 2 * 1024 * 4, 67e12),
    "K3": ("cca_label", dict(b=5, h=1024, w=1024), 0, 5 * 1024 * 1024 * 5,
           67e12),
    "K8": ("quantize_rows", dict(rows=9728, k=4096, itemsize=2),
           4 * 9728 * 4096, 9728 * 4096 * (2 + 1) + 4 * 9728, 67e12),
    "K9": ("int8_dense", dict(m=9728, k=4096, n=1024),
           2 * 9728 * 4096 * 1024,
           (9728 + 1024) * 4096 + 4 * (9728 + 2 * 1024) + 9728 * 1024 * 2,
           1979e12),
}
# the shape-derived bounds in ms, as rounded in PERF.md
_BOUNDS = {"K7": (0.217, "operations"), "K6": (0.027, "operations"),
           "K2": (0.046, "operations"), "K4 global": (0.174, "operations"),
           "K4 window": (0.033, "bytes"), "K5": (0.163, "operations"),
           "K1": (0.006, "bytes"), "row13": (0.52, "operations"),
           "row14": (0.186, "operations"), "K3": (0.008, "bytes"),
           "K8": (0.036, "bytes"), "K9": (0.041, "operations")}


@pytest.mark.parametrize("case", list(_HAND))
def test_kernel_cost_hand_values(case):
    name, shapes, flops, nbytes, peak = _HAND[case]
    got = roofline.kernel_cost(name, **shapes)
    ms, by = _bound(flops, nbytes, peak)
    assert got[:2] == (flops, nbytes)
    assert got[2] == pytest.approx(ms, rel=1e-12) and got[3] == by
    assert (round(got[2], 3 if got[2] < 0.5 else 2), got[3]) == _BOUNDS[case]


# ---------------------------------------------------- timing and traces


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_entry_raises_without_cuda(tool, no_cuda):
    mod = importlib.import_module(f"protosam_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_chip_smoke_refuses_without_cuda(no_cuda):
    """Without a card ``chip_smoke.py`` exits non-zero and prints no result
    line."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "CUDA is not available" in out.stderr


def test_stage_timer_needs_a_card_to_sync(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        StageTimer()


def test_stage_timer_accounting():
    timer = StageTimer(device="cpu", sync=False)
    for _ in range(3):
        with timer.stage("a"):
            time.sleep(0.002)
    with pytest.raises(ValueError):
        with timer.stage("b"):
            raise ValueError  # a failed stage is still charged
    d = timer.as_dict()
    assert d["a"]["calls"] == 3 and d["b"]["calls"] == 1
    assert d["a"]["total_s"] >= 0.006
    lines = timer.report().splitlines()
    assert lines[0].startswith("a: ") and "x3" in lines[0]
    assert lines[1].startswith("b: ")


def test_trace_summary_busy_idle_and_top_kernels():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "forward_volume",
         "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 90.0,
         "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 105.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 155.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 195.0, "dur": 20.0},
    ]
    out = trace_volume.summarize(ev, top=2)
    # busy: [100, 115) + [150, 165) + [195, 200) = 35 of 100 us
    assert out["window_ms"] == pytest.approx(0.1)
    assert out["busy_ms"] == pytest.approx(0.035)
    assert out["idle_share"] == pytest.approx(0.65)
    assert out["kernels"] == 5
    assert [(k["name"], k["calls"]) for k in out["top"]] == [("k1", 2),
                                                             ("k3", 1)]
    assert out["top"][0]["ms"] == pytest.approx(0.03)
    with pytest.raises(ValueError):
        trace_volume.summarize(ev[1:])


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::attention_kernel<__nv_bfloat16, 64, true, "
     "false>((anonymous namespace)::AttnArgs)",
     "attention_kernel<__nv_bfloat16, 64, true, false>"),
    ("(anonymous namespace)::cca_merge(unsigned char const*, int*, int)",
     "cca_merge"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT",
     "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT"),
])
def test_trace_short_kernel_names(name, short):
    assert trace_volume.short_name(name) == short


def test_ptxas_report_parses_ptxas_output():
    out = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 20480 bytes smem, 376 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers, 352 bytes cmem[0]
"""
    assert ptxas_report.parse(out) == {
        "_Z1kPf": {"registers": 96, "smem": 20480, "spill": (4, 12)},
        "_Z1gv": {"registers": 32, "smem": 0, "spill": (0, 0)}}


def test_pipeline_profile_instruments_the_five_stages():
    """The stage wrappers see every stage of a tiny ``forward_volume`` on
    the CPU, leave its result unchanged and are removed afterwards."""
    pipe = build_pipeline("cpu", sam_ver="vit_t", coarse="dinov2_t14",
                          image_size=126, sam_size=256, dtype=torch.float32,
                          seed=3, config=ProtoSAMConfig(image_size=(256, 256),
                                                        max_ccs=4))
    vol, inp = smooth_volume(4, 126, seed=4), synthetic_episode(126, "cpu", 5)
    want = pipe.forward_volume(vol, inp, slice_batch=2)
    timer = StageTimer(device="cpu", sync=False)
    methods = pipeline_profile.stage_methods(pipe)
    for name, (obj, attr) in methods.items():
        setattr(obj, attr, pipeline_profile._timed(timer, name,
                                                   getattr(obj, attr)))
    got = pipe.forward_volume(vol, inp, slice_batch=2)
    for obj, attr in methods.values():
        delattr(obj, attr)
    counts = {k: v["calls"] for k, v in timer.as_dict().items()}
    # support features once, query features and the rest once per batch
    assert counts == {"DINOv2 get_features": 3, "ALP score": 2,
                      "_extract_prompts": 2, "SAM encode_image": 2,
                      "_decode_stage": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(attr not in vars(obj) for obj, attr in methods.values())


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_k6_at_the_fc2_geometry(cuda):
    x, w, b, r = bench_fc2.to_kernel_layout(*bench_fc2.fc2_inputs(), cuda)
    got = dense_residual(x, w, b, r)
    want = dense_residual_plain(x.float(), w, b, r).float()
    assert got.shape == (bench_fc2.M, bench_fc2.N)
    err = (got.float() - want).abs().max().item()
    assert err <= BF16_TOL * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_k2_bf16_scores_variant(cuda):
    """The bf16-score instantiation at (2, 2432, 3072) on scores spread ~4:
    ``check_v3`` holds it to the plain v3 and finds K2 (f32 scores) apart
    from it; its launches are counted apart from K2's."""
    qkv = torch.from_numpy(microbench_attn.qkv_input(b=2)
                           * microbench_attn.LOGIT_SCALE).to(
        device=cuda, dtype=torch.bfloat16)
    kw = dict(scale=microbench_attn.SCALE, num_heads=microbench_attn.NH,
              n_valid=microbench_attn.N_VALID)
    fn = tattn.masked_flash_attention_packed
    before = (fn.launches, fn.bf16_score_launches)
    out = microbench_attn.check_v3(qkv, **kw)
    assert (fn.launches, fn.bf16_score_launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert out["mean_err"] <= microbench_attn.V3_SHARE * out["v0_mean_gap"]
    with pytest.raises(TypeError):
        fn(qkv.float(), score_dtype=torch.bfloat16, **kw)
