"""The port's int8 W8A8 dense path (``protosam_tpu_torch/ops/quant.py``,
kernels K8 ``quantize_rows`` and K9 ``int8_dense``) against JAX
``protosam_tpu/ops/quant.py`` and the JAX quant builds, on the CPU.

The plain versions are held to JAX's bits: the same codes, scales with the
same bit patterns, the same int32 products.  The dequantized output may
differ by one unit in the last place of its type, where XLA fuses the
epilogue differently.  Whole encoders cannot be held to JAX's bits: an
f32 difference upstream of a quantize (a convolution or a matmul summed in
another order, ~1e-6) can move a value across a rounding boundary and flip
a code, and a flipped code moves the next layer by a whole step of its
row's scale, which flips more codes downstream.  So each encoder test
measures that sensitivity on the port itself (the same input times 1 +
1e-6) and holds the port-to-JAX distance within twice it, and within half
of what int8 changes against the f32 build.  (SAM vit_t at 256²: port to
JAX 2.9e-3, the port against itself at 1e-6 3.1e-3, int8 against
f32 8.2e-3, while one layer on a shared input agrees to one ulp.)

The bf16 builds (``cast_compute`` in the port, ``dtype=bf16`` in JAX: the
flagship's composition, bf16 activations and f32 params in every int8
layer) are held to the same sensitivity bound, but not to half of int8's
move: bf16 rounding alone puts the two implementations about that far
apart (SAM vit_t: port to JAX 7.7e-3 without int8, int8's move 1.07e-2).
So a bf16 test holds instead the port's int8 move from its own bf16 build
within 5% of JAX's, and every int8 layer, on the input it was given inside
the port's encoder, to JAX ``int8_dense`` with the f32 params and a bf16
output, to one ulp: that is where a wiring fault (weights rounded to bf16
before quantizing, an output in the wrong type) shows.  One of them runs
SAM ViT-B's width at 1024² (two blocks), the flagship's geometry.  The
``cuda`` tests hold K8 and K9 bit-equal to the plain versions on the card."""

import copy

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.dinov2.vit import \
        DinoVisionTransformer as JDinoVisionTransformer
    from protosam_tpu.models.dinov2.vit import build_dinov2 as jbuild_dinov2
    from protosam_tpu.models.io_protocol import ALPNetInput as JALPNetInput
    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.models.sam.sam import Sam as JSam
    from protosam_tpu.ops import quant as jquant
    from protosam_tpu.pipeline.protosam import ProtoSAM as JProtoSAM
    from protosam_tpu.pipeline.protosam import ProtoSAMConfig as JConfig
    from protosam_tpu.utils.torch_convert import convert_dinov2, convert_sam
except ImportError:
    pass

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.eval.protosam_eval import build_models
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.dinov2.vit import (DinoVisionTransformer,
                                                  build_dinov2)
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.models.sam.sam import Sam
from protosam_tpu_torch.ops import quant
from protosam_tpu_torch.ops.resize import resize_bilinear
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

torch.set_num_threads(2)

NUDGE = 1e-6  # relative input perturbation that measures the sensitivity


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()
    return torch.device("cuda")


def seeded_state_dict(module, seed):
    """The synthetic fill, LayerNorm2d weights near 1, plus N(0, 0.05²)
    on every entry, so biases are non-zero and attention is far from
    uniform."""
    rng = np.random.default_rng(seed + 100)
    return {k: v + torch.from_numpy(
                0.05 * rng.standard_normal(tuple(v.shape), dtype=np.float32))
            for k, v in synthetic_state_dict(module, seed,
                                             unit_norm2d=True).items()}


def rows_with_edge_cases(n, k, seed):
    """Rows at scales 1e-3..1e2, a zero row, a row of exact .5 ties (amax
    127, so the scale is 1 and x / scale is x), and a row below the 1e-12
    clamp."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, k))
         * 10.0 ** rng.uniform(-3, 2, (n, 1))).astype(np.float32)
    x[1] = 0.0
    x[2] = 0.0
    x[2, 0] = 127.0
    ties = np.arange(min(16, (k - 1) // 2), dtype=np.float32) + 0.5
    x[2, 1:1 + len(ties)] = ties
    x[2, 1 + len(ties):1 + 2 * len(ties)] = -ties
    x[3] = 1e-14
    return x


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_within_int8_sensitivity(port, x, want, want_f32):
    """``port(x)`` against JAX's int8 output ``want``: within twice the
    port's own move under x * (1 + NUDGE), and within half of int8's move
    against the f32 output ``want_f32``."""
    with torch.no_grad():
        got, nudged = port(x), port(x * (1 + NUDGE))
    gap = rel_l2(got, want)
    sensitivity = rel_l2(nudged, got)
    assert gap <= 2 * sensitivity, (gap, sensitivity)
    assert gap <= 0.5 * rel_l2(want, want_f32), (gap, want_f32)


@pytest.mark.parametrize("k", [160, 768])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_matches_jax(dtype, k):
    x = rows_with_edge_cases(37, k, seed=k)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    q, scale = quant.quantize_symmetric(tx)
    jq, jscale = jquant.quantize_symmetric(jx, axis=-1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.shape == (37, 1)
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  np.asarray(jscale).view(np.int32))
    # the ties round half to even, and the zero row gives codes 0
    ties = np.arange(16) + 0.5
    assert q[2, 1:17].tolist() == np.round(ties).astype(int).tolist()
    assert q[2, 1:5].tolist() == [0, 2, 2, 4]
    assert not q[1].any()


def test_int8_product_matches_jax_dot_general():
    """The int32 sums, also past 2^24 where f32 would round them."""
    rng = np.random.default_rng(0)
    k = 5120
    qa = rng.integers(-127, 128, (24, k)).astype(np.int8)
    qb = rng.integers(-127, 128, (40, k)).astype(np.int8)
    qa[0] = 127
    qb[0] = 127  # one sum of K * 127² = 82,580,480 > 2^24
    got = quant.int8_product_plain(torch.from_numpy(qa), torch.from_numpy(qb))
    want = jax.lax.dot_general(jnp.asarray(qa), jnp.asarray(qb.T),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == k * 127 * 127


def ulp_diff(a, b, dtype):
    """Distance in units of the last place of ``dtype`` between f32 arrays
    that hold values of that type (the bit patterns mapped to a monotonic
    integer scale, so +0 and -0 are one point)."""
    def ordered(v):
        bits = v.view(np.uint32).astype(np.int64)
        if dtype == "bf16":
            bits >>= 16
        sign = 1 << (15 if dtype == "bf16" else 31)
        return np.where(bits & sign, -(bits & (sign - 1)), bits)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_dense_matches_jax(dtype, bias):
    rng = np.random.default_rng(1)
    x = rows_with_edge_cases(50, 160, seed=2)
    w = (0.05 * rng.standard_normal((160, 96))).astype(np.float32)  # (K, N)
    b = rng.standard_normal(96).astype(np.float32) if bias else None
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           None if b is None else torch.from_numpy(b), tdt)
    want = jquant.int8_dense(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), jdt)
    assert got.dtype == tdt and got.shape == (50, 96)
    g = got.float().numpy()
    h = np.asarray(want.astype(jnp.float32))
    assert ulp_diff(g, h, dtype).max() <= 1
    # codes 0 for the zero row: its output is the bias (or 0) in the type
    zero_row = torch.from_numpy(b if bias else np.zeros(96, np.float32))
    np.testing.assert_array_equal(g[1], zero_row.to(tdt).float().numpy())


def test_padding_rows_do_not_change_valid_rows():
    """Per-token scales: rows appended after the valid ones (zeros, as
    DINOv2's sequence padding, or the qkv bias, as SAM's window padding)
    leave every valid row's output as it was."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((45, 768)).astype(np.float32))
    w = torch.from_numpy(0.03 * rng.standard_normal((192, 768)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(192).astype(np.float32))
    want = quant.int8_dense(x, w, b, torch.float32)
    for pad in (torch.zeros(83, 768), b[:1].expand(83, 768) * 100.0):
        got = quant.int8_dense(torch.cat([x, pad]), w, b, torch.float32)
        torch.testing.assert_close(got[:45], want, atol=0, rtol=0)
    zero_rows = quant.int8_dense(torch.zeros(5, 768), w, b, torch.float32)
    torch.testing.assert_close(zero_rows, b.expand(5, 192), atol=0, rtol=0)


def test_quant_linear_is_an_nn_linear_that_stays_f32():
    """The same keys and shapes as ``nn.Linear``, so state_dicts load
    either way; ``cast_compute`` leaves its params and the norms' f32 and
    unrounded while the rest of the block goes to bf16."""
    lin, q = torch.nn.Linear(64, 96), quant.QuantLinear(64, 96)
    assert {k: v.shape for k, v in lin.state_dict().items()} == \
        {k: v.shape for k, v in q.state_dict().items()}
    q.load_state_dict(lin.state_dict())
    blk = build_dinov2("dinov2_vitt14", quant_dense=True).blocks[0]
    blk.load_state_dict(seeded_state_dict(blk, 0))
    before = {k: v.clone() for k, v in blk.state_dict().items()}
    cast_compute(blk, torch.bfloat16)
    for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        for p in ("weight", "bias"):
            key = f"{name}.{p}"
            assert blk.state_dict()[key].dtype == torch.float32, key
            assert torch.equal(blk.state_dict()[key], before[key]), key
    assert blk.ls1.gamma.dtype == torch.bfloat16
    for key in ("norm1.weight", "norm2.bias"):
        assert blk.state_dict()[key].dtype == torch.float32, key
        assert torch.equal(blk.state_dict()[key], before[key]), key


def quant_layers(module):
    return [n for n, m in module.named_modules()
            if isinstance(m, quant.QuantLinear)]


@pytest.mark.parametrize("quant_dense", [True, False],
                         ids=["quant", "control"])
def test_quant_routing_skips_the_fused_routes(monkeypatch, quant_dense):
    """With ``fused_mlp`` and ``fused_proj`` on, a bf16 quant SAM encoder
    calls neither K6 nor K7 and runs every dense stage on the int8 path;
    the control (quant off) calls both.  The decoder never quantizes."""
    from protosam_tpu_torch.models import layers
    from protosam_tpu_torch.models.sam import image_encoder

    seen = []

    def recorder(name, fn):
        def call(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(image_encoder, "dense_residual",
                        recorder("K6", image_encoder.dense_residual))
    monkeypatch.setattr(layers, "mlp_fused",
                        recorder("K7", layers.mlp_fused))
    monkeypatch.setattr(quant, "int8_dense",
                        recorder("int8", quant.int8_dense))
    sam = build_sam("vit_t", image_size=128, fused_mlp=True, fused_proj=True,
                    quant_dense=quant_dense).eval()
    sam.load_state_dict(seeded_state_dict(sam, 1))
    cast_compute(sam.image_encoder, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        emb = sam.encode_image(x)
    assert torch.isfinite(emb.float()).all()
    depth = len(sam.image_encoder.blocks)
    if quant_dense:
        assert seen == ["int8"] * (4 * depth)
        assert len(quant_layers(sam.image_encoder)) == 4 * depth
    else:
        assert sorted(set(seen)) == ["K6", "K7"]
        assert not quant_layers(sam.image_encoder)
    assert not quant_layers(sam.prompt_encoder)
    assert not quant_layers(sam.mask_decoder)


@pytest.fixture(scope="module")
def tiny_quant_models():
    """dinov2_t14 FewShotSeg at 126 px and SAM vit_t at 256, int8 on, f32,
    with their JAX params."""
    coarse = FewShotSeg(image_size=126, which_model="dinov2_t14",
                        quant_dense=True).eval()
    csd = seeded_state_dict(coarse, 0)
    coarse.load_state_dict(csd)
    sam = build_sam("vit_t", image_size=256, quant_dense=True).eval()
    ssd = seeded_state_dict(sam, 1)
    sam.load_state_dict(ssd)
    jparams = ({"encoder": convert_dinov2(
        {k[len("encoder."):]: v.numpy() for k, v in csd.items()
         if k.startswith("encoder.")})},
        convert_sam({k: v.numpy() for k, v in ssd.items()}))
    return coarse, sam, jparams


def test_dinov2_quant_matches_jax(tiny_quant_models):
    """dinov2_vitt14 at 28² (a 2 x 2 grid), int8 on both sides."""
    coarse, _, (jcp, _) = tiny_quant_models
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 28, 28)).astype(np.float32)
    want = {q: np.asarray(jbuild_dinov2("dinov2_vitt14", quant_dense=q).apply(
        {"params": jcp["encoder"]}, jnp.asarray(x.transpose(0, 2, 3, 1)))
        ["x_norm_patchtokens"]) for q in (True, False)}
    assert len(quant_layers(coarse.encoder)) == 4 * 2
    assert_within_int8_sensitivity(
        lambda t: coarse.encoder(torch.from_numpy(t))
        ["x_norm_patchtokens"].numpy(), x, want[True], want[False])


def test_sam_encoder_quant_matches_jax(tiny_quant_models):
    """SAM vit_t at 256² (a 16² grid: a windowed block padded to 28², whose
    pad tokens carry the qkv bias, and a global block), int8 on both sides.
    (At 128² the JAX build stores shorter rel-pos tables than a 14² window
    reads, so the two builds cannot share params there.)"""
    _, sam, (_, params) = tiny_quant_models
    x = np.random.default_rng(0).standard_normal(
        (2, 256, 256, 3)).astype(np.float32)
    want = {}
    for q in (True, False):
        jsam = jbuild_sam("vit_t", image_size=256, quant_dense=q)
        want[q] = np.asarray(jsam.apply({"params": params}, jnp.asarray(x),
                                        method=jsam.encode_image))
    assert_within_int8_sensitivity(
        lambda t: sam.encode_image(torch.from_numpy(
            t.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1),
        x, want[True], want[False])


def bf16_build(module):
    """A copy of ``module`` cast as ``entry.build_pipeline`` casts the
    encoders: bf16, with the norms and the int8 layers in f32."""
    return cast_compute(copy.deepcopy(module), torch.bfloat16)


class PortCall:
    """A numpy-in, numpy-out call of a port model that keeps the model at
    hand for the layer hooks."""

    def __init__(self, model, fn):
        self.model, self.fn = model, fn

    def __call__(self, x):
        return self.fn(self.model, x)


def run_recording_dense(model, run):
    """``run()`` with every ``QuantLinear`` of ``model`` recorded: its
    result and {name: (the layer's input, its output)}."""
    seen, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, quant.QuantLinear):
            hooks.append(m.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, (i[0], o))))
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def assert_bf16_quant_matches_jax(port_q, port_n, x, want_q, want_n, sd,
                                  prefix):
    """A bf16 int8 build against JAX's.  ``port_q`` / ``port_n`` give the
    port's int8 / plain bf16 outputs, ``want_q`` / ``want_n`` are JAX's on
    ``x``; ``sd`` is the f32 state_dict both sides were built from and
    ``prefix`` the int8 layers' key prefix in it.  The int8 gap may exceed
    the plain bf16 builds' own gap by twice the port's sensitivity; the
    port's int8 moves its output from its bf16 build no further than JAX's
    does, within 10%; each int8 layer is JAX's to one ulp."""
    with torch.no_grad():
        got, layers = run_recording_dense(port_q.model, lambda: port_q(x))
        nudged, plain = port_q(x * (1 + NUDGE)), port_n(x)
    gap, sensitivity = rel_l2(got, want_q), rel_l2(nudged, got)
    assert gap <= rel_l2(plain, want_n) + 2 * sensitivity, \
        (gap, rel_l2(plain, want_n), sensitivity)
    move, jmove = rel_l2(got, plain), rel_l2(want_q, want_n)
    assert move <= 1.1 * jmove, (move, jmove)
    assert len(layers) == len(quant_layers(port_q.model)) > 0
    for name, (xi, yi) in layers.items():
        assert xi.dtype == yi.dtype == torch.bfloat16, name
        w = sd[f"{prefix}{name}.weight"].numpy()
        b = sd[f"{prefix}{name}.bias"].numpy()
        with jax.disable_jit():  # op by op, as the encoder ran: compiled
            want = jquant.int8_dense(
                jnp.asarray(xi.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(w.T), jnp.asarray(b), jnp.bfloat16)
        ulps = ulp_diff(yi.float().numpy(),
                        np.asarray(want.astype(jnp.float32)), "bf16")
        assert ulps.max() <= 1, (name, int(ulps.max()))


def sam_embedding(sam, x):
    """(B, H, W, 3) f32 pixels -> the (B, h, w, 256) embedding as f32, the
    pixels given in the build's type."""
    dt = sam.image_encoder.patch_embed.proj.weight.dtype
    t = torch.from_numpy(x.transpose(0, 3, 1, 2)).to(dt)
    return sam.encode_image(t).float().numpy().transpose(0, 2, 3, 1)


def jax_sam_embedding(jsam, params, x):
    with jax.disable_jit():  # XLA:CPU cannot run the bf16 encoder's dots
        # under jit (DotThunk: BF16 x BF16 = F32); op by op it can
        return np.asarray(jsam.apply({"params": params}, jnp.asarray(x),
                                     method=jsam.encode_image)
                          .astype(jnp.float32))


# One block a build in the bf16 tests: JAX compiles a scan of two blocks op
# by op in seconds, and one in a fraction of one.
ONE_BLOCK_DINO = dict(embed_dim=64, depth=1, num_heads=2)


def test_dinov2_quant_bf16_matches_jax():
    """A one-block dinov2_vitt14 at 28², bf16 activations, int8 on both
    sides."""
    builds = {q: DinoVisionTransformer(quant_dense=q, **ONE_BLOCK_DINO).eval()
              for q in (True, False)}
    sd = seeded_state_dict(builds[True], 0)
    for m in builds.values():
        m.load_state_dict(sd)
    params = convert_dinov2({k: v.numpy() for k, v in sd.items()})
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 28, 28)).astype(np.float32)
    want = {}
    for q in (True, False):
        with jax.disable_jit():
            want[q] = np.asarray(JDinoVisionTransformer(
                dtype=jnp.bfloat16, quant_dense=q, **ONE_BLOCK_DINO).apply(
                {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
                ["x_norm_patchtokens"].astype(jnp.float32))

    def tokens(enc, t):
        return enc(torch.from_numpy(t))["x_norm_patchtokens"].float().numpy()

    assert_bf16_quant_matches_jax(
        PortCall(bf16_build(builds[True]), tokens),
        PortCall(bf16_build(builds[False]), tokens),
        x, want[True], want[False], sd, "")


def test_sam_encoder_quant_bf16_matches_jax():
    """A one-block windowed SAM vit_t at 256² (the 16² grid padded to 28²,
    the pad tokens carrying the qkv bias), bf16 activations, int8 on both
    sides.  JAX stores every block's rel-pos tables at the grid's 31 rows
    (the used slice is the window's 27), so the converted tables are padded
    to 31 as the converter pads a windowed block beside a global one."""
    kw = dict(encoder_embed_dim=160, encoder_depth=1, encoder_num_heads=4,
              encoder_global_attn_indexes=())
    builds = {q: Sam(image_size=256, quant_dense=q, **kw).eval()
              for q in (True, False)}
    sd = seeded_state_dict(builds[True], 1)
    for m in builds.values():
        m.load_state_dict(sd)
    params = convert_sam({k: v.numpy() for k, v in sd.items()})
    attn = params["image_encoder"]["blocks"]["attn"]
    for k in ("rel_pos_h", "rel_pos_w"):
        attn[k] = jnp.pad(attn[k], ((0, 0), (0, 31 - attn[k].shape[1]),
                                    (0, 0)))
    x = np.random.default_rng(0).standard_normal(
        (2, 256, 256, 3)).astype(np.float32)
    want = {q: jax_sam_embedding(JSam(
        image_size=256, dtype=jnp.bfloat16, decoder_dtype=jnp.float32,
        quant_dense=q, **kw), params, x) for q in (True, False)}
    assert_bf16_quant_matches_jax(
        PortCall(bf16_build(builds[True]), sam_embedding),
        PortCall(bf16_build(builds[False]), sam_embedding),
        x, want[True], want[False], sd, "")


VITB_TWO_BLOCKS = dict(encoder_embed_dim=768, encoder_depth=2,
                       encoder_num_heads=12, encoder_global_attn_indexes=(1,))


@pytest.mark.slow  # ~40 s on the CPU: the int8 products run in float64
def test_sam_vitb_quant_bf16_matches_jax():
    """The flagship's SAM geometry: ViT-B's width (768, 12 heads of 64,
    window 14) at 1024², cut to two blocks (a windowed one, whose 64² grid
    pads to 70² with the qkv bias, and a global one over 4096 tokens), bf16
    activations, int8 on both sides, on synthetic weights with no added
    noise and LayerNorm2d weights near 1: the recipe on which the
    flagship's int8 masks moved furthest from bf16's."""
    sd = synthetic_state_dict(Sam(image_size=1024, **VITB_TWO_BLOCKS), 1,
                              unit_norm2d=True)
    builds = {}
    for q in (True, False):
        builds[q] = Sam(image_size=1024, quant_dense=q,
                        **VITB_TWO_BLOCKS).eval()
        builds[q].load_state_dict(sd)
    params = convert_sam({k: v.numpy() for k, v in sd.items()})
    x = np.random.default_rng(0).standard_normal(
        (1, 1024, 1024, 3)).astype(np.float32)
    want = {q: jax_sam_embedding(JSam(
        image_size=1024, dtype=jnp.bfloat16, decoder_dtype=jnp.float32,
        quant_dense=q, **VITB_TWO_BLOCKS), params, x) for q in (True, False)}
    assert_bf16_quant_matches_jax(
        PortCall(bf16_build(builds[True]), sam_embedding),
        PortCall(bf16_build(builds[False]), sam_embedding),
        x, want[True], want[False], sd, "")


def dice(a, b):
    a, b = a > 0.5, b > 0.5
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * (a & b).sum() / den


def test_pipeline_quant_matches_jax(tiny_quant_models):
    """The tiny pipeline with int8 on both sides: masks at Dice >= 0.99."""
    coarse, sam, (jcp, jsp) = tiny_quant_models
    rng = np.random.default_rng(0)
    supp = rng.standard_normal((1, 3, 126, 126)).astype(np.float32)
    fg = np.zeros((1, 126, 126), np.float32)
    fg[:, 42:84, 42:84] = 1.0
    low = torch.from_numpy(rng.standard_normal((4, 3, 21, 21),
                                               dtype=np.float32))
    vol = (resize_bilinear(low, (126, 126)) * 3.0).numpy()
    pipe = ProtoSAM(coarse, sam, ProtoSAMConfig(image_size=(256, 256),
                                                max_ccs=4))
    preds, scores = pipe.forward_volume(
        torch.from_numpy(vol),
        ALPNetInput(torch.from_numpy(supp), torch.from_numpy(fg),
                    torch.from_numpy(vol[:1])), slice_batch=2)
    jpipe = JProtoSAM(
        JFewShotSeg(image_size=126, which_model="dinov2_t14",
                    quant_dense=True), jcp,
        jbuild_sam("vit_t", image_size=256, quant_dense=True), jsp,
        JConfig(image_size=(256, 256), max_ccs=4))
    jpreds, _ = jpipe.forward_volume(
        jnp.asarray(vol), JALPNetInput(jnp.asarray(supp), jnp.asarray(fg),
                                       jnp.asarray(vol[:1])), slice_batch=2)
    jpreds = np.asarray(jpreds)
    assert preds.shape == jpreds.shape
    for p, jp in zip(preds.numpy(), jpreds):
        assert dice(p, jp) >= 0.99
    assert 0.0 < float(preds.mean()) < 1.0


def test_build_models_with_quant_dense():
    """``build_models`` takes ``cfg.quant_dense``: both encoders' dense
    stages are int8 layers with f32 params under bf16, and nothing else
    is."""
    cfg = Config(modelname="dinov2_t14", input_size=(126, 126),
                 protosam_sam_ver="vit_t", quant_dense=True)
    pipe = build_models(cfg, device="cpu")
    enc, sam = pipe.coarse_model.encoder, pipe.sam_model
    assert len(quant_layers(enc)) == 4 * len(enc.blocks)
    assert len(quant_layers(sam.image_encoder)) == \
        4 * len(sam.image_encoder.blocks)
    assert not quant_layers(sam.prompt_encoder)
    assert not quant_layers(sam.mask_decoder)
    assert enc.blocks[0].attn.qkv.weight.dtype == torch.float32
    assert enc.blocks[0].ls1.gamma.dtype == torch.bfloat16


# ---------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(1, 16), (37, 160), (300, 768),
                                    (4864, 1024), (129, 1280), (65, 3072),
                                    (40, 4096), (33, 5120), (7, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_kernel_matches_plain(cuda, rows, k, dtype):
    """K8 against its plain version, bit for bit: register-held rows and
    the loop kernel (f32 K >= 3072, K = 100), edge-case rows included."""
    x = torch.from_numpy(rows_with_edge_cases(max(rows, 4), k, seed=rows)
                         [:rows].copy()).to(cuda, dtype)
    q, s = quant.quantize_rows(x)
    pq, ps = quant.quantize_rows_plain(x)
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    q2, s2 = quant.quantize_rows(x)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1, 1, 16), (100, 136, 160),
                                   (129, 127, 48), (300, 2304, 768),
                                   (4864, 1024, 4096), (8200, 3840, 1280),
                                   (33, 5120, 1280), (257, 1280, 5120)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_dense_kernel_matches_plain(cuda, m, n, k, out_dtype):
    """K9 against its plain version, bit for bit, at ragged M and N, odd
    N, K steps that end inside a tile, with and without a bias; a rerun
    gives the same bits."""
    g = torch.Generator().manual_seed(m * 7 + n)
    qa = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    qb = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    sx = torch.rand(m, generator=g) * 1e-2
    sw = torch.rand(n, generator=g) * 1e-3
    bias = torch.randn(n, generator=g)
    qa, qb, sx, sw, bias = (t.to(cuda) for t in (qa, qb, sx, sw, bias))
    for b in (bias, None):
        got = quant.int8_matmul_dequant(qa, qb, sx, sw, b, out_dtype)
        want = quant.int8_matmul_dequant_plain(qa, qb, sx, sw, b, out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want)
    again = quant.int8_matmul_dequant(qa, qb, sx, sw, bias, out_dtype)
    assert torch.equal(again, quant.int8_matmul_dequant(qa, qb, sx, sw, bias,
                                                        out_dtype))


@pytest.mark.cuda
def test_int8_dense_kernel_refuses_k_not_a_multiple_of_16(cuda):
    qa = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    qb = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        quant.int8_matmul_dequant(qa, qb, s, s, None, torch.float32)


@pytest.mark.cuda
def test_int8_dense_on_card_matches_cpu(cuda):
    """``int8_dense`` end to end (two K8, one K9) on the card equals the
    CPU's plain route bit for bit, padding rows included."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rows_with_edge_cases(2432 + 64, 1024, seed=5))
    x[2305:] = 0.0
    w = torch.from_numpy(0.03 * rng.standard_normal((3072, 1024)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(3072).astype(np.float32))
    for dt in (torch.bfloat16, torch.float32):
        before = quant.int8_matmul_dequant.launches
        got = quant.int8_dense(x.to(cuda, dt), w.to(cuda), b.to(cuda), dt)
        want = quant.int8_dense(x.to(dt), w, b, dt)
        assert quant.int8_matmul_dequant.launches == before + 1
        assert torch.equal(got.cpu(), want)
