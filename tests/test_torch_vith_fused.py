"""The SAM ViT-H refine configuration of the port against the JAX package:
the fused ALP match (K5), the fused projection (K6) and MLP (K7), a narrow
SAM at ViT-H's head width 80, the vit_h / vit_l converters, the fused-ALP
coarse model and pipeline, and ``build_models``.

The same numpy-seeded arrays go to the JAX function (the Pallas kernels in
interpret mode, as their own tests run them) and to the port on the CPU,
where each kernel wrapper takes its plain version.  Tests marked ``cuda``
compare the hand-written kernels with those plain versions and skip
without a GPU.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from protosam_tpu.eval import protosam_eval as jeval
    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.io_protocol import ALPNetInput as JALPNetInput
    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.models.sam.image_encoder import Block as JBlock
    from protosam_tpu.models.sam.sam import Sam as JSam
    from protosam_tpu.ops import alp as jalp
    from protosam_tpu.ops.alp_pallas import alp_match_fused as jalp_fused
    from protosam_tpu.ops.mlp_pallas import dense_residual as jdense
    from protosam_tpu.ops.mlp_pallas import mlp_fused as jmlp
    from protosam_tpu.pipeline.protosam import ProtoSAM as JProtoSAM
    from protosam_tpu.pipeline.protosam import ProtoSAMConfig as JConfig
    from protosam_tpu.utils.config import Config as JExpConfig
    from protosam_tpu.utils.config import load_config as jload_config
    from protosam_tpu.utils.torch_convert import convert_dinov2, convert_sam
except ImportError:
    pass

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.models.sam.sam import Sam
from protosam_tpu_torch.ops import alp as talp
from protosam_tpu_torch.ops import mlp as tmlp
from protosam_tpu_torch.ops.resize import resize_bilinear
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.tools import bench_mlp_kernel
from protosam_tpu_torch.utils import convert
from protosam_tpu_torch.utils.config import Config, load_config
from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

torch.set_num_threads(2)

BF16_TOL = 2e-2  # x max(1, max|ref|)


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


def seeded_state_dict(module, seed):
    """The synthetic fill, LayerNorm2d weights near 1, plus N(0, 0.05²)
    on every entry, so biases are non-zero and attention is far from
    uniform."""
    rng = np.random.default_rng(seed + 100)
    return {k: v + torch.from_numpy(
                0.05 * rng.standard_normal(tuple(v.shape), dtype=np.float32))
            for k, v in synthetic_state_dict(module, seed,
                                             unit_norm2d=True).items()}


def jax_dinov2_params(sd, prefix=""):
    return convert_dinov2({k[len(prefix):]: v.numpy() for k, v in sd.items()
                           if k.startswith(prefix)})


def dice(a, b):
    a, b = a > 0.5, b > 0.5
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * (a & b).sum() / den


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


# ------------------------------------------------- K6 / K7 plain versions

_DTYPES = {"f32": (torch.float32, "float32"), "bf16": (torch.bfloat16,
                                                         "bfloat16")}
# tests/test_mlp_pallas.py: bf16 at 3e-2; f32 here at 1e-5
_MLP_TOL = {"f32": dict(atol=1e-5, rtol=1e-5),
            "bf16": dict(atol=3e-2, rtol=3e-2)}


def _mlp_arrays(rng, m, c, h):
    return (rng.standard_normal((m, c)).astype(np.float32),
            (rng.standard_normal((c, h)) * 0.05).astype(np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32),
            (rng.standard_normal((h, c)) * 0.05).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            rng.standard_normal((m, c)).astype(np.float32))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("with_residual", [True, False])
@pytest.mark.parametrize("m,c,h", [(256, 128, 512), (96, 256, 384)])
def test_mlp_fused_plain_matches_jax_kernel(m, c, h, with_residual, kind):
    tdt, jdt = _DTYPES[kind]
    x, w1, b1, w2, b2, res = _mlp_arrays(np.random.default_rng(0), m, c, h)
    res = res if with_residual else None
    j = lambda a: None if a is None else jnp.asarray(a, jdt)
    tt = lambda a: None if a is None else t(a).to(tdt)
    want = jmlp(j(x), j(w1), j(b1), j(w2), j(b2), residual=j(res),
                interpret=True)
    # the port takes the nn.Linear layout (out, in)
    got = tmlp.mlp_fused_plain(tt(x), tt(w1.T), tt(b1), tt(w2.T), tt(b2),
                               tt(res))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_MLP_TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [
    (256, 128, 512), (96, 256, 384),
    (100, 136, 72),  # M, K and N ragged to K6's 128 x 160 x 64 tiles
])
def test_dense_residual_plain_matches_jax_kernel(m, k, n, kind):
    tdt, jdt = _DTYPES[kind]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    j = lambda a: jnp.asarray(a, jdt)
    want = jdense(j(x), j(w), j(b), j(res), interpret=True)
    got = tmlp.dense_residual(*(t(a).to(tdt) for a in (x, w.T, b, res)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_MLP_TOL[kind])


def test_check_exchange_control_fails_the_bf16_bound(monkeypatch):
    """On the CPU the wrapper is the plain version, so ``check_exchange``
    holds its bf16 run against its f32 run; the control with two peers'
    chunks swapped must land beyond the bf16 bound, and a kernel that read
    one peer's chunk for the other's must fail the check."""
    x, w1, b1, w2, b2, res = (t(a).to(torch.bfloat16) for a in _mlp_arrays(
        np.random.default_rng(8), 96, 128, 1024))
    w1, w2 = w1.T.contiguous(), w2.T.contiguous()  # nn.Linear layout
    out = bench_mlp_kernel.check_exchange(x, w1, b1, w2, b2, res)
    assert out["control_max_err"] > 10 * out["bound"]
    assert out["max_abs_err"] <= out["bound"]
    w1s, w2s = bench_mlp_kernel.exchange_scaled(w1, w2)
    assert torch.equal(w1s[64:128].float(), 2 * w1[64:128].float())
    assert torch.equal(w2s[:, 192:256].float(), 8 * w2[:, 192:256].float())
    assert torch.equal(w2s[:, 576:640].float(), 2 * w2[:, 576:640].float())
    monkeypatch.setattr(
        bench_mlp_kernel, "mlp_fused",
        lambda x, w1, b1, w2, b2, r: tmlp.mlp_fused_plain(
            x, w1, b1, bench_mlp_kernel.swap_peers(w2), b2, r))
    with pytest.raises(AssertionError, match="mixes up"):
        bench_mlp_kernel.check_exchange(x, w1, b1, w2, b2, res)


# ------------------------------------------------------ K5 plain version


@pytest.mark.parametrize("n,c,h,w,p,all_invalid", [
    (2, 40, 13, 11, 75, False),     # rows 143, P 75: neither a tile multiple
    (1, 64, 17, 16, 129, False),    # P just past 128
    (1, 32, 8, 9, 16, True),        # every prototype invalid: exactly 0
    (1, 48, 7, 6, 1, False),        # one prototype
    (1, 48, 9, 7, 300, False),      # K5 splits the range in three
])
def test_alp_match_fused_plain_matches_jax_kernel(n, c, h, w, p,
                                                  all_invalid):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((n, c, h, w)).astype(np.float32)
    protos = rng.standard_normal((p, c)).astype(np.float32)
    valid = np.zeros(p, bool) if all_invalid else rng.random(p) > 0.3
    want = np.asarray(jalp_fused(jnp.asarray(q), jnp.asarray(protos),
                                 jnp.asarray(valid), interpret=True))
    got = talp.alp_match_fused(t(q), t(protos), t(valid)).numpy()
    assert got.shape == (n, 1, h, w)
    if all_invalid:
        np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["gridconv", "gridconv+"])
def test_score_prototypes_fused_matches_jax_kernel(mode):
    """alp_score(use_fused=True) on the CPU against the JAX route through
    the Pallas kernel: 20x18 features, so P and the rows are ragged."""
    rng = np.random.default_rng(3)
    qry = rng.standard_normal((2, 32, 20, 18)).astype(np.float32)
    sup = rng.standard_normal((1, 32, 20, 18)).astype(np.float32)
    mask = np.zeros((1, 1, 20, 18), np.float32)
    mask[0, :, 3:13, 4:12] = 1.0
    got = talp.alp_score(t(qry), t(sup), t(mask), mode, 2, 0.95,
                         use_fused=True)
    want = jalp.alp_score(*map(jnp.asarray, (qry, sup, mask)), mode, 2, 0.95,
                          use_fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------- SAM at ViT-H's head width 80

_NARROW = dict(encoder_embed_dim=160, encoder_depth=2, encoder_num_heads=2,
               encoder_global_attn_indexes=(1,), image_size=256)


@pytest.fixture(scope="module")
def narrow_sam():
    """hd 80 (160 wide, 2 heads), depth 2, global block 1, at 256 px: a 16²
    grid, so block 0 pads 16 -> 28 for its 14² windows."""
    model = Sam(**_NARROW).eval()
    sd = seeded_state_dict(model, 4)
    model.load_state_dict(sd)
    return model, sd, convert_sam({k: v.numpy() for k, v in sd.items()})


def test_narrow_vith_encoder_matches_jax(narrow_sam):
    model, _, params = narrow_sam
    jsam = JSam(decoder_dtype=jnp.float32, **_NARROW)
    x = np.random.default_rng(5).standard_normal(
        (1, 256, 256, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.encode_image(t(x.transpose(0, 3, 1, 2)))
    want = jax.jit(functools.partial(jsam.apply, method=jsam.encode_image))(
        {"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("index", [0, 1], ids=["window", "global"])
def test_fused_block_bf16_matches_jax(narrow_sam, index, monkeypatch):
    """One bf16 block with both fused routes (the port's plain versions of
    K6/K7) against the JAX block under PTPU_MLP_PALLAS / PTPU_PROJ_PALLAS."""
    _, sd, params = narrow_sam
    model = Sam(fused_mlp=True, fused_proj=True, **_NARROW).eval()
    model.load_state_dict(sd)
    blk = cast_compute(model.image_encoder.blocks[index], torch.bfloat16)
    assert blk.fused_mlp and blk.fused_proj
    x = np.random.default_rng(6).standard_normal(
        (2, 16, 16, 160)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    with torch.no_grad():
        got = blk(t(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16

    monkeypatch.setenv("PTPU_MLP_PALLAS", "1")
    monkeypatch.setenv("PTPU_PROJ_PALLAS", "1")
    jblk = JBlock(num_heads=2, window_size=14, grid_size=16, embed_dim=160,
                  dtype=jnp.bfloat16, use_flash_relpos=True)
    bp = jax.tree_util.tree_map(lambda a: a[index],
                                params["image_encoder"]["blocks"])
    with jax.disable_jit():  # XLA:CPU cannot run this block's fused bf16
        # dots under jit (DotThunk: BF16 x BF16 = F32); op by op it can
        want, _ = jblk.apply({"params": bp}, xb, jnp.asarray(index == 1))
    assert_bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("model_type", ["vit_h", "vit_l"])
def test_converter_covers_vith_and_vitl(model_type, monkeypatch):
    """sam_state_dict of the JAX param tree (shapes only, from
    jax.eval_shape: no forward, no weights) gives exactly the keys and
    shapes of the port's model; lin1/lin2 need no new rule."""
    jsam = jbuild_sam(model_type)
    shapes = jax.eval_shape(
        jsam.init, jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1024, 3)),
        jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32),
        jnp.zeros((1, 4)))["params"]
    params = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    monkeypatch.setattr(convert, "_t", lambda a: torch.empty(
        np.shape(a), device="meta"))
    with torch.device("meta"):
        model = build_sam(model_type)
    got = convert.sam_state_dict(params, model.encoder_global_attn_indexes)
    want = model.state_dict()
    assert set(got) == set(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert sum(k.startswith("image_encoder.blocks.")
               and k.endswith("mlp.lin1.weight") for k in got) == len(
        model.image_encoder.blocks)


# ------------------------------------------ fused-ALP coarse model, pipeline


@pytest.fixture(scope="module")
def tiny_models():
    coarse = FewShotSeg(image_size=126, which_model="dinov2_t14",
                        use_fused_alp=True).eval()
    csd = seeded_state_dict(coarse, 0)
    coarse.load_state_dict(csd)
    sam = build_sam("vit_t", image_size=256, fused_mlp=True,
                    fused_proj=True).eval()
    ssd = seeded_state_dict(sam, 1)
    sam.load_state_dict(ssd)
    jparams = ({"encoder": jax_dinov2_params(csd, "encoder.")},
               convert_sam({k: v.numpy() for k, v in ssd.items()}))
    rng = np.random.default_rng(7)
    supp = rng.standard_normal((1, 3, 126, 126)).astype(np.float32)
    fg = np.zeros((1, 126, 126), np.float32)
    fg[:, 42:84, 42:84] = 1.0
    low = t(rng.standard_normal((4, 3, 21, 21), dtype=np.float32))
    vol = (resize_bilinear(low, (126, 126)) * 3.0).numpy()
    return coarse, sam, jparams, supp, fg, vol


def test_fewshot_fused_alp_logits_match_jax(tiny_models):
    coarse, _, (jcp, _), supp, fg, vol = tiny_models
    jmodel = JFewShotSeg(image_size=126, which_model="dinov2_t14",
                         use_fused_alp=True)
    args = (supp, fg, 1 - fg, vol[:2])
    with torch.no_grad():
        got = coarse(*map(t, args))["logits"]
    want = jax.jit(jmodel.apply)({"params": jcp}, *map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want["logits"]),
                               atol=2e-4, rtol=1e-4)


def test_pipeline_all_fused_flags_matches_jax(tiny_models, monkeypatch):
    """The tiny pipeline with use_fused_alp, fused_mlp and fused_proj (the
    two encoder routes are inert in f32, as in the JAX package) against the
    JAX pipeline with the same flags."""
    coarse, sam, (jcp, jsp), supp, fg, vol = tiny_models
    cfg = dict(image_size=(256, 256), max_ccs=4)
    preds, scores = ProtoSAM(coarse, sam, ProtoSAMConfig(**cfg)
                             ).forward_volume(
        t(vol), ALPNetInput(t(supp), t(fg), t(vol[:1])), slice_batch=2)

    monkeypatch.setenv("PTPU_MLP_PALLAS", "1")
    monkeypatch.setenv("PTPU_PROJ_PALLAS", "1")
    jpipe = JProtoSAM(JFewShotSeg(image_size=126, which_model="dinov2_t14",
                                  use_fused_alp=True),
                      jcp, jbuild_sam("vit_t", image_size=256), jsp,
                      JConfig(**cfg))
    jpreds, jscores = jpipe.forward_volume(
        jnp.asarray(vol), JALPNetInput(jnp.asarray(supp), jnp.asarray(fg),
                                       jnp.asarray(vol[:1])), slice_batch=2)
    jpreds = np.asarray(jpreds)
    assert preds.shape == jpreds.shape
    for p, jp in zip(preds.numpy(), jpreds):
        assert dice(p, jp) >= 0.99
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-4)
    assert 0.0 < float(preds.mean()) < 1.0


# ------------------------------------------------------------ build_models

_CONFIGS = [
    dict(modelname="dinov2_t14", input_size=(126, 126),
         protosam_sam_ver="vit_t", do_cca=True, use_fused_alp=True,
         max_ccs=4, dtype="float32", seed=3),
    dict(modelname="dinov2_t14", protosam_sam_ver="vit_t", use_bbox=False,
         point_mode="conf", use_neg_points=True, coarse_pred_only=True),
    dict(modelname="dinov2_t14", input_size=(126, 126),
         protosam_sam_ver="vit_t", use_mask=True, use_points=False,
         use_bbox=False, proto_grid_size=4, point_mode="centroid"),
]


@pytest.mark.parametrize("overrides", _CONFIGS, ids=["cca-fused-alp",
                                                     "conf-neg-coarse",
                                                     "mask-grid4"])
def test_build_models_matches_jax(overrides):
    pipe = protosam_eval.build_models(Config(**overrides), device="cpu")
    jpipe = jeval.build_models(JExpConfig(**overrides), coarse_params={},
                               sam_params={})
    ours = dataclasses.asdict(pipe.config)
    theirs = dataclasses.asdict(jpipe.config)
    assert ours == {k: theirs[k] for k in ours}
    for attr in ("image_size", "which_model", "proto_grid_size",
                 "use_fused_alp", "feature_hw", "kernel_size"):
        assert (getattr(pipe.coarse_model, attr)
                == getattr(jpipe.coarse_model, attr)), attr
    enc = pipe.sam_model.image_encoder
    assert pipe.sam_model.image_size == jpipe.sam_model.image_size
    assert (len(enc.blocks), enc.blocks[0].attn.num_heads,
            enc.pos_embed.shape[-1]) == (
        jpipe.sam_model.encoder_depth, jpipe.sam_model.encoder_num_heads,
        jpipe.sam_model.encoder_embed_dim)
    want_dtype = torch.float32 if overrides.get("dtype") == "float32" \
        else torch.bfloat16
    assert enc.patch_embed.proj.weight.dtype == want_dtype


def test_build_models_passes_routes_and_seed():
    cfg = Config(modelname="dinov2_t14", input_size=(126, 126),
                 protosam_sam_ver="vit_t", seed=5)
    a = protosam_eval.build_models(cfg, device="cpu", fused_mlp=True,
                                   fused_proj=True)
    b = protosam_eval.build_models(cfg, device="cpu")
    assert all(blk.fused_mlp and blk.fused_proj
               for blk in a.sam_model.image_encoder.blocks)
    assert not any(blk.fused_mlp or blk.fused_proj
                   for blk in b.sam_model.image_encoder.blocks)
    for x, y in zip(a.sam_model.parameters(), b.sam_model.parameters()):
        assert torch.equal(x, y)
    assert protosam_eval.SAM_VERSIONS == jeval.SAM_VERSIONS


@pytest.mark.parametrize("overrides,err", [
    # an orbax checkpoint directory: JAX's format, not read by the port
    (dict(modelname="dinov2_t14", protosam_sam_ver="vit_t",
          reload_model_path="alpnet_orbax"), NotImplementedError),
    (dict(protosam_sam_ver="vit_t"), KeyError),  # dlfcn_res101 backbone
], ids=["checkpoint", "resnet"])
def test_build_models_refuses_what_is_not_ported(overrides, err):
    with pytest.raises(err):
        protosam_eval.build_models(Config(**overrides), device="cpu")


def test_config_matches_jax_config():
    ours, theirs = Config(), JExpConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    argv = ["with", "modelname=dinov2_l14", "input_size=[672,672]",
            "use_fused_alp=True", "protosam_sam_ver=sam_h", "path.log_dir=x"]
    assert dataclasses.asdict(load_config(argv)) == dataclasses.asdict(
        jload_config(argv))


# -------------------------------------------------------- CUDA kernels


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,p,invalid", [
    (2, 40, 13, 11, 75, None), (1, 1024, 48, 48, 577, None),
    (3, 64, 7, 5, 130, None), (1, 32, 8, 9, 16, "all"),
    # K5 splits the prototypes in blocks of ALP_SPLIT = 128 and combines
    # the splits' softmax partials: one prototype, one split just short,
    # exact and just past, several with the last one ragged
    (2, 64, 9, 9, 1, None), (2, 64, 9, 9, 127, None),
    (2, 64, 9, 9, 128, None), (2, 64, 9, 9, 129, None),
    (2, 96, 16, 16, 1153, None), (4, 1024, 48, 48, 576, None),
    # the whole second split invalid, the others not; all invalid
    (2, 96, 16, 16, 300, "split 1"), (2, 96, 16, 16, 300, "all")])
def test_alp_kernel_matches_plain(cuda, n, c, h, w, p, invalid):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(n, c, h, w, generator=g).to(cuda)
    protos = torch.randn(p, c, generator=g).to(cuda)
    valid = torch.rand(p, generator=g) > 0.3
    if invalid == "all":
        valid[:] = False
    elif invalid == "split 1":
        valid[talp.ALP_SPLIT:2 * talp.ALP_SPLIT] = False
    valid = valid.to(cuda)
    before = talp.alp_match_fused.launches
    got = talp.alp_match_fused(q, protos, valid)
    assert talp.alp_match_fused.launches == before + 1
    want = talp.alp_match_fused_plain(q, protos, valid)
    if invalid == "all":
        assert torch.equal(got, torch.zeros_like(got))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    # the splits combine in a fixed order with no atomics
    assert torch.equal(talp.alp_match_fused(q, protos, valid), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (256, 128, 512),
    (100, 136, 72),      # M, N and K (136 = 2 x 64 + 8) ragged to the tiles
    (8192, 1280, 1280),  # the ViT-H projection: 512 tiles on the SMs
    (100, 1280, 1280),   # fewer tiles (8) than SMs
    (8264, 1280, 1280),  # M ragged; 520 tiles, an uneven share a block
    (300, 768, 768),     # ViT-B: N ragged to the 160-column tile
    (100, 136, 75),      # odd N: the epilogue's one-at-a-time stores
    (39200, 5120, 1280),  # the fc2 geometry of tools/bench_fc2.py
])
def test_dense_residual_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(1)
    bf = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(
        cuda, torch.bfloat16)
    x, w, b, res = bf(m, k), bf(n, k, sc=0.05), bf(n, sc=0.1), bf(m, n)
    got = tmlp.dense_residual(x, w, b, res)
    want = tmlp.dense_residual_plain(x.float(), w, b, res)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got.float().cpu(), want.cpu())
    assert torch.equal(got, tmlp.dense_residual(x, w, b, res))


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [True, False])
@pytest.mark.parametrize("m,c,h", [
    (256, 128, 512), (100, 160, 336), (2000, 1280, 5120),
    (300, 768, 3072), (300, 1024, 4096),  # ViT-B and ViT-L widths
    (100, 144, 336),    # a ragged column slice: 36 -> 40 a block, C masked
    (8264, 1280, 5120),  # M ragged to the 128-row cluster tile
])
def test_mlp_fused_kernel_matches_plain(cuda, m, c, h, with_residual):
    g = torch.Generator().manual_seed(2)
    bf = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(
        cuda, torch.bfloat16)
    x, w1, b1 = bf(m, c), bf(h, c, sc=0.05), bf(h, sc=0.1)
    w2, b2 = bf(c, h, sc=0.05), bf(c, sc=0.1)
    res = bf(m, c) if with_residual else None
    got = tmlp.mlp_fused(x, w1, b1, w2, b2, res)
    want = tmlp.mlp_fused_plain(x.float(), w1, b1, w2, b2, res)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got.float().cpu(), want.cpu())
    assert torch.equal(got, tmlp.mlp_fused(x, w1, b1, w2, b2, res))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,h", [(300, 1280, 5120), (200, 144, 512)])
def test_mlp_fused_kernel_reads_each_peer_chunk(cuda, m, c, h):
    """``check_exchange`` on the card: each peer block's hidden chunk
    scaled by its own factor, a swapped-chunk control that fails."""
    g = torch.Generator().manual_seed(5)
    bf = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(
        cuda, torch.bfloat16)
    out = bench_mlp_kernel.check_exchange(
        bf(m, c), bf(h, c, sc=0.03), bf(h, sc=0.1), bf(c, h, sc=0.015),
        bf(c, sc=0.1), bf(m, c))
    assert out["control_max_err"] > out["bound"] >= out["max_abs_err"]


@pytest.mark.cuda
def test_fused_block_on_card_matches_cpu(cuda):
    """The narrow hd-80 SAM's two bf16 blocks with both fused routes (K1,
    K4, K6, K7) against the CPU run of the same block."""
    model = Sam(fused_mlp=True, fused_proj=True, **_NARROW).eval()
    model.load_state_dict(seeded_state_dict(model, 4))
    cast_compute(model.image_encoder, torch.bfloat16)
    x = torch.randn(2, 16, 16, 160,
                    generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    with torch.no_grad():
        want = [blk(x) for blk in model.image_encoder.blocks]
        model.to(cuda)
        got = [blk(x.to(cuda)) for blk in model.image_encoder.blocks]
    for a, b in zip(got, want):
        assert_bf16_close(a.float().cpu(), b.float())
