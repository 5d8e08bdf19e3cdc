"""DINOv2 ViT-g/14 in the port (``models/dinov2/vit.py``: the gated
``SwiGLUFFN``, the ``dinov2_vitg14`` variant, ``dinov2_g14`` in
``models/alpnet/fewshot.py``) against the plain float32 reference
``tests/plain_dinov2.py``, which follows the hub's code and imports only
``torch``.  The JAX package has no giant variant, so nothing here imports
JAX.

On the CPU the gated path runs a test-size variant (``dinov2_vitgt14``: 96
wide, 2 blocks, 4 heads, hidden 256 by the hub's rule) on seeded weights.
The tests marked ``cuda`` hold one block at the published widths and the
whole encoder at 672 px on the card to the same reference.

Tolerances, each with its reason:

* ``F32_TOL`` 1e-5 relative L2: the port and the reference compute the
  same float32 operations in another order (the attention, the norms, the
  bicubic resize), ~1e-7 a layer; 1e-5 leaves a hundredfold, and bf16
  rounding (~1e-2) or a wrong activation (~1e-1) lies far beyond it.
* int8: the port's own int8 tolerances (``tests/test_torch_quant.py``):
  within twice the port's move under an input nudged by 1e-6, and within
  half of what int8 changes against float32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_dinov2 as plain
from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.eval.protosam_eval import build_models
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.dinov2 import vit
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.ops.quant import QuantLinear
from protosam_tpu_torch.ops.resize import resize_bilinear
from protosam_tpu_torch.parallel import encoder_param_sharding, make_mesh
from protosam_tpu_torch.parallel import sharding
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.convert import hf_dinov2_to_hub_state_dict
from protosam_tpu_torch.utils.synthetic import synthetic_state_dict
from test_torch_parallel import _spawn

torch.set_num_threads(2)

F32_TOL = 1e-5
NUDGE = 1e-6
TINY = "dinov2_vitgt14"
SIZE = 126  # 9 x 9 patches


def rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def seeded_state_dict(module, seed):
    """The synthetic fill plus N(0, 0.05²) on every entry, so biases are
    non-zero and attention is far from uniform."""
    rng = np.random.default_rng(seed + 100)
    return {k: v + torch.from_numpy(
                0.05 * rng.standard_normal(tuple(v.shape), dtype=np.float32))
            for k, v in synthetic_state_dict(module, seed).items()}


def tiny_model(name=TINY, seed=0, quant_dense=False):
    model = vit.build_dinov2(name, quant_dense=quant_dense).eval()
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd)
    return model, sd


def images(n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return resize_bilinear(torch.randn(n, 3, 21, 21, generator=g),
                           (SIZE, SIZE)) * 3.0


def port(model, x):
    with torch.no_grad():
        return model(x)["x_norm_patchtokens"]


def heads(name):
    return vit._DINO_CONFIGS[name]["num_heads"]


def ffn(name):
    return vit._DINO_CONFIGS[name].get("ffn", "mlp")


# ------------------------------------------------------------- the layer


def test_gated_variant_is_the_hubs():
    """The gated block's keys, widths and hidden rule: ``w12`` (2h, C),
    ``w3`` (C, h), h = (int(4·C·2/3) + 7) // 8 · 8."""
    assert vit.SwiGLUFFN.hidden_features(1536, 4) == 4096
    assert vit.SwiGLUFFN.hidden_features(96, 4) == 256
    assert plain.swiglu_hidden(1536) == 4096
    blk = vit.build_dinov2(TINY).blocks[0]
    assert isinstance(blk.mlp, vit.SwiGLUFFN)
    assert tuple(blk.mlp.w12.weight.shape) == (512, 96)
    assert tuple(blk.mlp.w3.weight.shape) == (96, 256)
    # the GELU variants keep fc1-GELU-fc2
    assert isinstance(vit.build_dinov2("dinov2_vitt14").blocks[0].mlp,
                      vit.Mlp)


@pytest.mark.parametrize("name", [TINY, "dinov2_vitt14"])
def test_matches_plain_reference_f32(name):
    """The port's f32 encoder against the plain reference, gated and GELU
    variants alike, within ``F32_TOL``."""
    model, sd = tiny_model(name)
    x = images()
    got = port(model, x)
    want = plain.forward(sd, x, heads(name), ffn(name))
    assert got.shape == want.shape == (2, 81, model.embed_dim)
    assert rel_l2(got, want) <= F32_TOL


def test_bf16_build_fails_the_f32_tolerance():
    """The port in bf16 (the configuration's precision) is the same model
    but leaves ``F32_TOL``: the tolerance sees a precision below f32."""
    model, sd = tiny_model()
    x = images()
    cast_compute(model, torch.bfloat16)
    gap = rel_l2(port(model, x), plain.forward(sd, x, heads(TINY), "swiglu"))
    assert F32_TOL < gap < 5e-2, gap


def _gelu_gate(self, x):
    x1, x2 = self.w12(x).chunk(2, dim=-1)
    return self.w3(F.gelu(x1) * x2)


def _swapped(self, x):
    x1, x2 = self.w12(x).chunk(2, dim=-1)
    return self.w3(F.silu(x2) * x1)


@pytest.mark.parametrize("fault", [_gelu_gate, _swapped],
                         ids=["gelu_for_silu", "x1_x2_swapped"])
def test_planted_faults_fail(monkeypatch, fault):
    model, sd = tiny_model()
    x = images()
    monkeypatch.setattr(vit.SwiGLUFFN, "forward", fault)
    gap = rel_l2(port(model, x), plain.forward(sd, x, heads(TINY), "swiglu"))
    assert gap > 100 * F32_TOL, gap


def test_int8_gated_ffn_within_int8_tolerances():
    """``quant_dense``: every dense layer of the gated blocks (qkv, proj,
    w12, w3) is an int8 layer, and the port's int8 encoder agrees with the
    reference computing the same W8A8 layers in plain torch."""
    model, sd = tiny_model(quant_dense=True)
    mlp = model.blocks[0].mlp
    assert isinstance(mlp.w12, QuantLinear) and isinstance(mlp.w3,
                                                           QuantLinear)
    x = images()
    got, nudged = port(model, x), port(model, x * (1 + NUDGE))
    want = plain.forward(sd, x, heads(TINY), "swiglu",
                         dense=plain.int8_linear)
    want_f32 = plain.forward(sd, x, heads(TINY), "swiglu")
    gap = rel_l2(got, want)
    assert gap <= 2 * rel_l2(nudged, got), gap
    assert gap <= 0.5 * rel_l2(want, want_f32), (gap, rel_l2(want, want_f32))


# ----------------------------------------------------- published widths


def _meta_state(layout, prefix=""):
    return {prefix + k: torch.empty(s, device="meta")
            for k, s in layout.items()}


def test_hub_layout_loads_strictly_through_build_models():
    """``build_models(Config(modelname="dinov2_g14", protosam_sam_ver=
    "sam_b"))`` loads a hub-layout ``dinov2_vitg14`` state dict strictly
    (meta tensors: keys and shapes only); the encoder has 1.14 B
    parameters, and a key missing or a fc1/fc2 layout raises."""
    layout = plain.hub_layout(1536, 40, "swiglu")
    assert round(sum(np.prod(s) for s in layout.values()) / 1e9, 2) == 1.14
    with torch.device("meta"):
        sam = build_sam("vit_b", image_size=1024)
    sam_state = {k: torch.empty_like(v) for k, v in sam.state_dict().items()}
    cfg = Config(modelname="dinov2_g14", protosam_sam_ver="sam_b",
                 input_size=(672, 672))
    pipe = build_models(cfg, device="meta",
                        coarse_state=_meta_state(layout, "encoder."),
                        sam_state=sam_state)
    enc = pipe.coarse_model.encoder
    assert {k: tuple(v.shape) for k, v in enc.state_dict().items()} == layout
    assert len(enc.blocks) == 40 and enc.blocks[0].attn.num_heads == 24
    bad = _meta_state(layout, "encoder.")
    del bad["encoder.blocks.39.mlp.w3.weight"]
    with pytest.raises(RuntimeError, match="blocks.39.mlp.w3.weight"):
        build_models(cfg, device="meta", coarse_state=bad,
                     sam_state=sam_state)
    gelu = _meta_state(plain.hub_layout(1536, 40, "mlp"), "encoder.")
    with pytest.raises(RuntimeError, match="mlp.fc1"):
        build_models(cfg, device="meta", coarse_state=gelu,
                     sam_state=sam_state)


def test_fewshot_takes_the_giant_alias():
    with torch.device("meta"):
        model = FewShotSeg(672, "dinov2_g14")
    assert model.encoder.embed_dim == 1536
    assert isinstance(model.encoder.blocks[0].mlp, vit.SwiGLUFFN)
    assert model.feature_hw == 48


def test_hf_gated_keys_convert():
    """A HuggingFace ``Dinov2Model`` layout with the gated FFN
    (``mlp.weights_in`` / ``mlp.weights_out``) converts to the hub's
    ``mlp.w12`` / ``mlp.w3`` and loads strictly into the port, giving the
    hub state dict's output."""
    model, sd = tiny_model()
    c = model.embed_dim
    hf = {"embeddings.cls_token": sd["cls_token"],
          "embeddings.mask_token": sd["mask_token"],
          "embeddings.position_embeddings": sd["pos_embed"],
          "embeddings.patch_embeddings.projection.weight":
              sd["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.projection.bias":
              sd["patch_embed.proj.bias"],
          "layernorm.weight": sd["norm.weight"],
          "layernorm.bias": sd["norm.bias"]}
    for i in range(len(model.blocks)):
        p, b = f"encoder.layer.{i}.", f"blocks.{i}."
        for kind in ("weight", "bias"):
            for j, n in enumerate(("query", "key", "value")):
                hf[f"{p}attention.attention.{n}.{kind}"] = \
                    sd[f"{b}attn.qkv.{kind}"][j * c:(j + 1) * c]
            hf[f"{p}attention.output.dense.{kind}"] = \
                sd[f"{b}attn.proj.{kind}"]
            for norm in ("norm1", "norm2"):
                hf[f"{p}{norm}.{kind}"] = sd[f"{b}{norm}.{kind}"]
            hf[f"{p}mlp.weights_in.{kind}"] = sd[f"{b}mlp.w12.{kind}"]
            hf[f"{p}mlp.weights_out.{kind}"] = sd[f"{b}mlp.w3.{kind}"]
        hf[f"{p}layer_scale1.lambda1"] = sd[f"{b}ls1.gamma"]
        hf[f"{p}layer_scale2.lambda1"] = sd[f"{b}ls2.gamma"]
    hub = hf_dinov2_to_hub_state_dict(hf)
    assert set(hub) == set(sd)
    other = vit.build_dinov2(TINY).eval()
    other.load_state_dict(hub)
    x = images(1)
    assert torch.equal(port(other, x), port(model, x))


# ------------------------------------------------------- tensor parallel


def _fake_mesh(n_model, model_rank):
    return sharding.Mesh(1, n_model, 0, model_rank, None, None)


def test_megatron_split_of_the_gated_ffn():
    """Over 2 model ranks, w12 keeps the same hidden units of its gate and
    of its value half (column-parallel), w3 those units' columns
    (row-parallel, the whole bias)."""
    full, _ = tiny_model()
    h = 256
    for r in range(2):
        part, _ = tiny_model()
        plan = encoder_param_sharding(part, _fake_mesh(2, r))
        assert plan["blocks.0.mlp.w12"] == "column"
        assert plan["blocks.0.mlp.w3"] == "row"
        units = torch.arange(r * h // 2, (r + 1) * h // 2)
        mlp, want = part.blocks[0].mlp, full.blocks[0].mlp
        torch.testing.assert_close(
            mlp.w12.weight, want.w12.weight[torch.cat([units, units + h])],
            rtol=0, atol=0)
        torch.testing.assert_close(mlp.w3.weight, want.w3.weight[:, units],
                                   rtol=0, atol=0)
        torch.testing.assert_close(mlp.w3.bias, want.w3.bias, rtol=0,
                                   atol=0)


def _tp_rank(rank):
    model, _ = tiny_model()
    x = images()
    want = port(model, x)
    plan = encoder_param_sharding(model, make_mesh(n_data=1, n_model=2))
    calls = dict(sharding.collective_calls)
    return {"want": want, "got": port(model, x), "plan": plan,
            "all_reduce": sharding.collective_calls["all_reduce"]
            - calls.get("all_reduce", 0)}


def test_tensor_parallel_gated_encoder_matches_one_rank():
    """The tiny gated encoder Megatron-split over two gloo ranks gives
    one rank's output (f32, within ``F32_TOL``: the row-parallel sums
    add two partial products), its FFN sharded, not left replicated."""
    res = _spawn(_tp_rank, 2)
    for r in res:
        assert r["plan"]["blocks.1.mlp.w12"] == "column"
        assert r["plan"]["blocks.1.mlp.w3"] == "row"
        # two row-parallel layers a block: proj and w3
        assert r["all_reduce"] == 4
        assert rel_l2(r["got"], r["want"]) <= F32_TOL


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only "
                    "there")
    set_f32_precision()
    return torch.device("cuda")


def _fill(module, seed, device):
    """The role recipe on the card: LayerNorm weights and LayerScale
    gammas 1 + 0.02·N, biases 0.02·N (non-zero here), the rest 0.02·N."""
    g = torch.Generator(device=device).manual_seed(seed)
    module.to_empty(device=device)
    with torch.no_grad():
        for k, p in module.state_dict().items():
            p.copy_(torch.randn(p.shape, generator=g, device=device) * 0.02)
            if k.endswith("gamma") or (".norm" in f".{k}"
                                       and k.endswith("weight")):
                p.add_(1.0)
    return module.eval()


# published widths on the card: f32 (TF32 off) within the f32 tolerance
# scaled by depth (one block 1e-5, 40 blocks 1e-4), bf16 within the
# encoders' bf16 rounding (1.4-1.6% in amplitude at DINOv2-L, PERF.md)
CARD_TOL = {("block", "f32"): 1e-5, ("block", "bf16"): 2e-2,
            ("encoder", "f32"): 1e-4, ("encoder", "bf16"): 5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_published_width_block_matches_reference(cuda, dtype):
    """One ViT-g block (1536 wide, 24 heads, hidden 4096) on the padded
    672-px sequence (2432 rows, 2305 valid) against the reference on the
    2305 real tokens."""
    with torch.device("meta"):
        blk = vit.Block(1536, 24, 4.0, ffn=vit.SwiGLUFFN)
    _fill(blk, 3, cuda)
    sd = {f"blocks.0.{k}": v.detach().clone()
          for k, v in blk.state_dict().items()}
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 2305, 1536, generator=g, device=cuda)
    want = plain.block(sd, 0, x, 24, "swiglu")
    if dtype == "bf16":
        cast_compute(blk, torch.bfloat16)
    xp = F.pad(x, (0, 0, 0, 127)).to(torch.bfloat16 if dtype == "bf16"
                                     else torch.float32)
    with torch.no_grad():
        got = blk(xp, 2305)[:, :2305]
    gap = rel_l2(got, want)
    print(f"ViT-g block {dtype}: rel L2 {gap:.3e}")
    assert gap <= CARD_TOL[("block", dtype)], gap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_published_width_encoder_matches_reference(cuda, dtype):
    """The whole ``dinov2_vitg14`` encoder at 672 px, one image."""
    with torch.device("meta"):
        model = vit.build_dinov2("dinov2_vitg14")
    _fill(model, 5, cuda)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=cuda).manual_seed(6)
    x = resize_bilinear(torch.randn(1, 3, 21, 21, generator=g, device=cuda),
                        (672, 672)) * 3.0
    want = plain.forward(sd, x, 24, "swiglu")
    del sd
    if dtype == "bf16":
        cast_compute(model, torch.bfloat16)
    got = port(model, x)
    gap = rel_l2(got, want)
    print(f"ViT-g encoder {dtype}: rel L2 {gap:.3e}")
    assert gap <= CARD_TOL[("encoder", dtype)], gap
