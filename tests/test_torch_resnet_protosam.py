"""The DeepLabV3 ResNet-101 coarse encoder in the port
(``models/backbones/resnet.py``, ``dlfcn_res101`` in
``models/alpnet/fewshot.py``) against the plain float32 reference
``tests/plain_resnet.py``, which follows torchvision's code and imports
only ``torch``; and ProtoSAM on it against the benchmark's plain coarse
head (``benchmark/reference/pipeline.coarse_scores``).  Nothing here
imports JAX.

On the CPU the published trunk (every layer, width and dilation) runs at
64 px on seeded weights: He-scaled convolutions and BatchNorm statistics
away from the identity, so every residual branch and every BatchNorm
moves the output.  The tests marked ``cuda`` hold the whole encoder at
672 px on the card to the same reference.

Tolerances, each with its reason:

* ``F32_TOL`` 1e-5 relative L2: the port and the reference compute the
  same float32 convolutions and BatchNorms (the port folds each into the
  convolution's weights and bias, or, under autograd, into a scale and a
  shift; the reference divides), ~1e-7 a layer; 1e-5 leaves a hundredfold,
  and bf16 rounding (~1e-2), a BatchNorm eps of 1e-3 or a misplaced ReLU
  lie far beyond it.
* ``SCORE_TOL`` 1e-5 relative L2 of the coarse scores: ALP is float32 in
  both on features that agree to ~1e-7, and its softmax-weighted cosine
  sums move the scores by no more than the features.
* On the card (``CARD_TOL``): f32 with TF32 off 1e-4, as cuDNN may pick
  other convolution algorithms for the port's and the reference's calls
  (~1e-6 a layer over 105 convolutions); bf16 5e-2, the encoder's bf16
  rounding (8 mantissa bits an operand, ~4e-3 a layer, partly cancelling
  over the depth), while a planted fault reads far beyond it.
"""

import json
import math
import pathlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import plain_resnet as plain
from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.eval.protosam_eval import build_models
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.backbones import resnet
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.utils.config import Config

torch.set_num_threads(2)

F32_TOL = 1e-5
SCORE_TOL = 1e-5
CARD_TOL = {"f32": 1e-4, "bf16": 5e-2}
SIZE = 64  # an 8 x 8 feature grid
STAGES = ("stem", "layer1", "layer2", "layer3", "layer4", "localconv")
CONFIG = (pathlib.Path(__file__).resolve().parents[1]
          / "benchmark/configs/protosam_r101_vitb.json")


def rel_l2(got, want) -> float:
    """Relative L2 gap; infinite where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    return float((got.float() - want.float()).norm() / want.float().norm())


def seeded_weights(shapes: dict, seed: int, device="cpu") -> dict:
    """He-scaled convolutions; BatchNorm weights 1 + 0.1·N, biases and
    running means 0.1·N, running variances in [0.5, 1.5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in shapes.items():
        n = torch.randn(shape, generator=g, device=device)
        if len(shape) == 4:
            fan_in = math.prod(shape[1:])
            out[k] = n * math.sqrt(2.0 / fan_in)
        elif k.endswith(".weight"):
            out[k] = 1.0 + 0.1 * n
        elif k.endswith(".running_var"):
            out[k] = 0.5 + torch.rand(shape, generator=g, device=device)
        else:
            out[k] = 0.1 * n
    return out


def images(n=2, size=SIZE, seed=1, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, 3, size, size, generator=g, device=device)


def port_stages(enc, x) -> dict:
    """The port's output of every stage (hooks on its modules)."""
    got = {}
    hooks = [enc.backbone.layer1.register_forward_pre_hook(
        lambda m, a: got.__setitem__("stem", a[0]))]
    for name in STAGES[1:5]:
        hooks.append(getattr(enc.backbone, name).register_forward_hook(
            lambda m, a, y, name=name: got.__setitem__(name, y)))
    try:
        with torch.no_grad():
            got["localconv"] = enc(x)
    finally:
        for h in hooks:
            h.remove()
    return got


class OpRecorder(TorchDispatchMode):
    """The aten ops dispatched inside the block, and each convolution's
    (output, weight) shapes."""

    def __init__(self):
        super().__init__()
        self.ops, self.convs = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(func.overloadpacket.__name__)
        if func.overloadpacket is torch.ops.aten.convolution:
            self.convs.append((tuple(out.shape), tuple(args[1].shape)))
        return out


@pytest.fixture(scope="module")
def published():
    """The published trunk on seeded weights, its inputs and the plain
    reference's stages."""
    enc = resnet.DeeplabRes101Encoder().eval()
    sd = seeded_weights(plain.layout(), 3)
    enc.load_state_dict(sd)
    x = images()
    return enc, sd, x, plain.forward(sd, x, stages=True)


def test_layout_is_the_ports():
    """The reference's torchvision layout is the port's state_dict."""
    enc = resnet.DeeplabRes101Encoder()
    assert plain.layout() == {k: tuple(v.shape)
                              for k, v in enc.state_dict().items()}
    assert enc.convs == 105


@pytest.mark.parametrize("size", [64, 97, 672])
def test_roofline_counts_the_convolutions_run(size):
    """``tools/roofline.resnet_flops`` equals 2 FLOP a multiply-add of
    every convolution the port runs, counted from the shapes of the
    convolutions it dispatches (on the meta device); 618.07 GFLOP an image
    at 672 px."""
    from protosam_tpu_torch.tools import roofline

    with torch.device("meta"):
        enc = resnet.DeeplabRes101Encoder()
        x = torch.empty(1, 3, size, size)
    with torch.no_grad(), OpRecorder() as rec:
        enc(x)
    run = [2 * math.prod(y) * math.prod(w[1:]) for y, w in rec.convs]
    got = roofline.dino_flops("dlfcn_res101", size)
    assert len(run) == 105
    assert sum(got.values()) == sum(run)
    if size == 672:
        assert sum(got.values()) == 618_070_376_448


def test_encoder_matches_reference_f32(published):
    enc, _, x, want = published
    with torch.no_grad():
        got = enc(x)
    assert got.shape == (2, 256, 8, 8)
    assert rel_l2(got, want["localconv"]) <= F32_TOL


@pytest.mark.parametrize("stage", STAGES)
def test_each_stage_matches_reference_f32(published, stage):
    enc, _, x, want = published
    got = port_stages(enc, x)
    assert rel_l2(got[stage], want[stage]) <= F32_TOL


def test_bf16_build_fails_the_f32_tolerance(published):
    _, sd, x, want = published
    enc = resnet.DeeplabRes101Encoder().eval()
    enc.load_state_dict(sd)
    cast_compute(enc, torch.bfloat16)
    with torch.no_grad():
        gap = rel_l2(enc(x), want["localconv"])
    assert F32_TOL * 100 < gap < CARD_TOL["bf16"], gap


def _layer3_strided(enc):
    """layer3 with torchvision's stride of 2 and no dilation."""
    first = enc.backbone.layer3[0]
    first.conv2.stride = (2, 2)
    first.downsample[0].stride = (2, 2)
    for blk in enc.backbone.layer3:
        blk.conv2.dilation = blk.conv2.padding = (1, 1)


def _eps(enc):
    for m in enc.modules():
        if isinstance(m, resnet.FrozenBatchNorm):
            m.eps = 1e-3


def _relu_before_add(enc):
    import torch.nn.functional as F

    for m in enc.modules():
        if isinstance(m, resnet.Bottleneck):
            def forward(x, b=m):
                out = F.relu(b.bn1(b.conv1(x)))
                out = F.relu(b.bn2(b.conv2(out)))
                out = F.relu(b.bn3(b.conv3(out)))
                identity = x if b.downsample is None else b.downsample(x)
                return out + identity
            m.forward = forward


def _no_localconv(enc):
    enc.localconv.forward = lambda y: y


@pytest.mark.parametrize("fault", [_layer3_strided, _eps, _relu_before_add,
                                   _no_localconv],
                         ids=["layer3_strided", "bn_eps_1e-3",
                              "relu_before_add", "no_localconv"])
def test_planted_faults_fail(published, fault):
    _, sd, x, want = published
    enc = resnet.DeeplabRes101Encoder().eval()
    enc.load_state_dict(sd)
    fault(enc)
    with torch.no_grad():
        gap = rel_l2(enc(x), want["localconv"])
    assert gap > 100 * F32_TOL, gap


# ------------------------------------------------ BatchNorm folded once

TEST_SIZE = ((1, 1, 2, 2), (8, 16, 32, 64))  # ``dlfcn_res_t``


def n_bns(enc) -> int:
    return sum(isinstance(m, resnet.FrozenBatchNorm) for m in enc.modules())


def traced_call(enc, x, monkeypatch, grad=False):
    """``enc(x)`` (under ``no_grad`` unless ``grad``) and its
    ``resnet.encode`` span."""
    from protosam_tpu_torch.utils import profiling

    rec = profiling.Recorder(capacity=64)
    monkeypatch.setattr(profiling, "span", rec.span)
    monkeypatch.setattr(profiling, "count", rec.count)
    with torch.set_grad_enabled(grad):
        y = enc(x)
    return y, next(s for s in rec.spans() if s.name == "resnet.encode")


@pytest.fixture
def test_size():
    """The test-size trunk on seeded weights, a second seed's weights and
    an input."""
    layout = plain.layout(*TEST_SIZE)
    enc = resnet.DeeplabRes101Encoder(*TEST_SIZE).eval()
    sd = seeded_weights(layout, 21)
    enc.load_state_dict(sd)
    return enc, sd, seeded_weights(layout, 22), images(2, 48, seed=23)


@pytest.mark.parametrize("size", ["published", "test_size"])
def test_folded_forward_matches_unfolded_and_reference(published, size,
                                                       monkeypatch):
    """Without grad the pairs run folded; with grad on the parameters,
    convolution and BatchNorm apart.  Both hold the reference."""
    if size == "published":
        enc, _, x, stages = published
        want, layers = stages["localconv"], plain.LAYERS
    else:
        layers, widths = TEST_SIZE
        enc = resnet.DeeplabRes101Encoder(layers, widths).eval()
        sd = seeded_weights(plain.layout(layers, widths), 9)
        enc.load_state_dict(sd)
        x = images(2, 48, seed=10)
        want = plain.forward(sd, x, layers, widths)
    folded, span = traced_call(enc, x, monkeypatch)
    unfolded, grad_span = traced_call(enc, x, monkeypatch, grad=True)
    assert unfolded.requires_grad and grad_span.attrs["bn_folds"] == 0
    assert span.attrs["bn_folds"] in (0, n_bns(enc))
    assert rel_l2(folded, want) <= F32_TOL
    assert rel_l2(unfolded.detach(), want) <= F32_TOL
    assert rel_l2(folded, unfolded.detach()) <= F32_TOL
    # every convolution but the localconv carries a BatchNorm
    assert n_bns(enc) == enc.convs - 1


def test_a_warm_call_builds_no_fold(test_size, monkeypatch):
    enc, _, _, x = test_size
    first, span = traced_call(enc, x, monkeypatch)
    assert span.attrs["bn_folds"] == n_bns(enc) == 23
    again, span = traced_call(enc, x, monkeypatch)
    assert span.attrs["bn_folds"] == 0
    assert torch.equal(first, again)


def _load(enc, other):
    enc.load_state_dict(other)
    return other, n_bns(enc)


def _in_place(enc, other):
    with torch.no_grad():
        enc.backbone.layer3[1].bn2.running_var.mul_(4.0)
        enc.backbone.layer3[1].conv2.weight.neg_()
    return {k: v.detach().clone() for k, v in enc.state_dict().items()}, 1


def _eps(enc, other):
    for m in enc.modules():
        if isinstance(m, resnet.FrozenBatchNorm):
            m.eps = 0.5
    return None, n_bns(enc)


def _dtype(enc, other):
    cast_compute(enc, torch.bfloat16)
    return None, n_bns(enc)


@pytest.mark.parametrize("change", [_load, _in_place, _eps, _dtype],
                         ids=["load_state_dict", "in_place", "eps", "dtype"])
def test_the_fold_is_rebuilt_when_the_weights_change(test_size, change,
                                                     monkeypatch):
    """After a load, an in-place write under ``no_grad``, a new ``eps``
    or a cast, the next call folds the changed pairs again, and its
    output is that of the changed weights (the unfolded path's)."""
    enc, sd, other, x = test_size
    before, _ = traced_call(enc, x, monkeypatch)
    now_sd, rebuilt = change(enc, other)
    got, span = traced_call(enc, x, monkeypatch)
    assert span.attrs["bn_folds"] == rebuilt
    assert traced_call(enc, x, monkeypatch)[1].attrs["bn_folds"] == 0
    unfolded, _ = traced_call(enc, x, monkeypatch, grad=True)
    if change is _dtype:
        assert got.dtype == torch.bfloat16
        assert F32_TOL * 100 < rel_l2(got, unfolded.detach()) \
            < CARD_TOL["bf16"]
        return
    assert rel_l2(got, before) > 100 * F32_TOL
    assert rel_l2(got, unfolded.detach()) <= F32_TOL
    if now_sd is not None:
        want = plain.forward(now_sd, x, *TEST_SIZE)
        assert rel_l2(got, want) <= F32_TOL


def test_a_grad_call_on_the_master_weights_build_moves_every_bn_vector(
        test_size, monkeypatch):
    """The training build (bf16 compute over f32 master weights) under
    grad takes the unfolded path: it folds nothing and the loss reaches
    all four vectors of every BatchNorm."""
    enc, _, _, x = test_size
    cast_compute(enc, torch.bfloat16, master_weights=True)
    y, span = traced_call(enc, x, monkeypatch, grad=True)
    assert span.attrs["bn_folds"] == 0 and y.dtype == torch.bfloat16
    y.float().square().mean().backward()
    for m in enc.modules():
        if isinstance(m, resnet.FrozenBatchNorm):
            for p in (m.weight, m.bias, m.running_mean, m.running_var):
                assert p.grad is not None and p.grad.dtype == torch.float32
                assert p.grad.abs().sum() > 0
    # the same build without grad folds from the f32 masters
    folded, span = traced_call(enc, x, monkeypatch)
    assert span.attrs["bn_folds"] == n_bns(enc)
    assert rel_l2(folded, y.detach()) < CARD_TOL["bf16"]


def test_a_warm_forward_dispatches_no_batchnorm_arithmetic(test_size):
    """Warm, the encoder dispatches its convolutions, the residual adds,
    the ReLUs and the max-pool, and nothing of BatchNorm: no square root,
    division or multiply."""
    enc, _, _, x = test_size
    with torch.no_grad():
        enc(x)
        with OpRecorder() as rec:
            enc(x)
    assert "convolution" in rec.ops and len(rec.convs) == enc.convs
    assert not {"sqrt", "div", "mul", "rsqrt"} & set(rec.ops), rec.ops


# ------------------------------------------------- through build_models


def _family_state(seed: int) -> dict:
    """The benchmark's configuration drawn as the benchmark draws it
    (``benchmark/harness/weights.py``), ALPNet's ``encoder.`` prefix."""
    from benchmark.harness import weights

    cfg = json.loads(CONFIG.read_text())
    return weights._draw(weights.coarse_keys(cfg), seed, "cpu")


def _config(**kw) -> Config:
    return Config(modelname="dlfcn_res101", protosam_sam_ver="vit_t",
                  input_size=(SIZE, SIZE), dtype="float32", log_dir="",
                  **kw)


@pytest.fixture
def small_sam(monkeypatch):
    monkeypatch.setattr(protosam_eval, "SAM_IMAGE_SIZE", 256)


def test_build_models_loads_the_family_keys_strictly(small_sam):
    state = _family_state(11)
    pipe = build_models(_config(), device="cpu", coarse_state=state)
    got = pipe.coarse_model.state_dict()
    assert got.keys() == state.keys()
    assert all(torch.equal(got[k], v) for k, v in state.items())
    missing = dict(state)
    del missing["encoder.backbone.layer3.22.bn2.running_var"]
    with pytest.raises(RuntimeError, match="layer3.22.bn2.running_var"):
        build_models(_config(), device="cpu", coarse_state=missing)
    extra = dict(state, **{"encoder.backbone.layer3.23.conv1.weight":
                           torch.zeros(256, 1024, 1, 1)})
    with pytest.raises(RuntimeError, match="layer3.23.conv1.weight"):
        build_models(_config(), device="cpu", coarse_state=extra)


def test_protosam_coarse_scores_match_the_plain_head(small_sam):
    """ProtoSAM on ``dlfcn_res101`` at 64 px (an 8 x 8 grid, BG grid
    prototypes of window 2, the FG fallback window 1): the coarse model's
    logits are the plain encoder's features through the benchmark's plain
    ALP head, upsampled to the image."""
    from benchmark.reference import pipeline as rp

    state = seeded_weights(plain.layout(), 5)
    pipe = build_models(_config(), device="cpu", coarse_state={
        "encoder." + k: v for k, v in state.items()})
    supp, qry = images(1, seed=2), images(3, seed=4)
    fg = torch.zeros(1, SIZE, SIZE)
    fg[:, 16:48, 12:44] = 1.0
    with torch.no_grad():
        out = pipe.coarse_model(supp, fg, 1.0 - fg, qry, isval=True,
                                val_wsize=2)
    sec = {"proto_grid": 8}
    want = rp.coarse_scores(plain.forward(state, qry),
                            plain.forward(state, supp), fg, sec)
    want = rp.bilinear(want, (SIZE, SIZE))
    assert out["logits"].shape == (3, 2, SIZE, SIZE)
    assert rel_l2(out["logits"], want) <= SCORE_TOL
    # the scores are not trivial: the two classes disagree somewhere
    pred = out["logits"].argmax(1)
    assert 0 < int(pred.sum()) < pred.numel()


def test_test_size_variant_keeps_the_trunks_dilations():
    """``dlfcn_res_t`` (the benchmark's CPU cell) is the published trunk's
    code at (1, 1, 2, 2) blocks and an eighth of its widths, output
    stride 8, against the reference at those sizes."""
    model = FewShotSeg(256, "dlfcn_res_t").eval()
    layers, widths = (1, 1, 2, 2), (8, 16, 32, 64)
    layout = plain.layout(layers, widths)
    enc = model.encoder
    assert layout == {k: tuple(v.shape) for k, v in enc.state_dict().items()}
    assert [b[4] for b in plain.blocks(layers, widths)] == [1, 1, 1, 2, 2, 4]
    sd = seeded_weights(layout, 7)
    enc.load_state_dict(sd)
    x = images(1, 96)
    with torch.no_grad():
        got = enc(x)
    assert got.shape == (1, 256, 12, 12) and model.feature_hw == 32
    assert rel_l2(got, plain.forward(sd, x, layers, widths)) <= F32_TOL


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    """The card at full f32 precision; without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the published encoder at 672 px is "
                    "checked on the card")
    set_f32_precision()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_published_encoder_at_672_matches_reference(cuda, dtype):
    """The whole encoder at 672 px and published widths, two images, as
    ``build_models`` casts it (bf16 convolutions, f32 BatchNorm
    parameters)."""
    sd = seeded_weights(plain.layout(), 13, cuda)
    with torch.device("meta"):
        enc = resnet.DeeplabRes101Encoder()
    enc.to_empty(device=cuda)
    enc.load_state_dict(sd)
    enc.eval()
    x = images(2, 672, 17, cuda)
    want = plain.forward(sd, x)
    if dtype == "bf16":
        cast_compute(enc, torch.bfloat16)
    with torch.no_grad():
        got = enc(x)
    torch.cuda.synchronize()
    gap = rel_l2(got, want)
    print(f"ResNet-101 encoder at 672 {dtype}: rel L2 {gap:.3e}")
    assert got.shape == (2, 256, 84, 84)
    assert gap <= CARD_TOL[dtype], gap
    if dtype == "bf16":
        assert gap > F32_TOL * 10, gap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_published_encoder_on_the_card_runs_each_pair_as_one_call(
        cuda, dtype, monkeypatch):
    """Warm, at 672 px: each convolution–BatchNorm pair followed by a ReLU
    is one of cuDNN's fused entries (bias, residual and ReLU in its
    epilogue), the downsamples and the localconv one convolution each, at
    most two host-side ops a convolution, nothing of BatchNorm's
    arithmetic and no fold built; the output holds the float32
    reference."""
    from collections import Counter

    sd = seeded_weights(plain.layout(), 13, cuda)
    with torch.device("meta"):
        enc = resnet.DeeplabRes101Encoder()
    enc.to_empty(device=cuda)
    enc.load_state_dict(sd)
    enc.eval()
    x = images(2, 672, 17, cuda)
    want = plain.forward(sd, x)
    if dtype == "bf16":
        cast_compute(enc, torch.bfloat16)
    assert traced_call(enc, x, monkeypatch)[1].attrs["bn_folds"] == 104
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got, span = traced_call(enc, x, monkeypatch)
    torch.cuda.synchronize()
    top = Counter(e.name for e in prof.events() if e.name.startswith("aten::")
                  and not (e.cpu_parent is not None
                           and e.cpu_parent.name.startswith("aten::")))
    gap = rel_l2(got, want)
    print(f"ResNet-101 encoder at 672 {dtype}, fused: rel L2 {gap:.3e}; "
          f"host ops {dict(top)}")
    assert span.attrs["bn_folds"] == 0
    assert top["aten::cudnn_convolution_relu"] == 1 + 2 * 33
    assert top["aten::cudnn_convolution_add_relu"] == 33
    assert top["aten::conv2d"] == 4 + 1
    assert sum(top.values()) <= 2 * enc.convs
    assert not {"aten::sqrt", "aten::div", "aten::mul"} & set(top)
    assert gap <= CARD_TOL[dtype], gap
