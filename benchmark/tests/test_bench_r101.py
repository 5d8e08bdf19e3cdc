"""The DeepLabV3 ResNet-101 model family (``families/deeplab_r101.py``)
against the port and hand counts, the tiny dilated-ResNet cell end to end
on the CPU with planted faults, and the ``resnet_mfu`` reader on hand-made
spans."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import cell, family, roofline, weights
from benchmark.harness.trace import Trace

from bench_tiny import make_root, run

BENCH = pathlib.Path(__file__).resolve().parents[1]
TINY_R = BENCH / "tests/tiny/configs/tiny_r.json"
R101 = BENCH / "configs/protosam_r101_vitb.json"


def _cfg(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", [R101, TINY_R], ids=["published", "tiny"])
def test_keys_are_the_ports(path):
    """The family's layout loads strictly into the port's model: the same
    keys and shapes as its ``state_dict``, BatchNorm's four vectors a
    norm, under torchvision's ``backbone.`` and the ``localconv``."""
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg

    cfg = _cfg(path)
    with torch.device("meta"):
        module = FewShotSeg(cfg["coarse"]["input_size"],
                            cfg["program"]["modelname"])
    keys = weights.coarse_keys(cfg)
    assert {k: tuple(s) for k, s, _ in keys} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    roles = {k: r for k, _, r in keys}
    p = "encoder.backbone.layer3.0."
    assert [roles[p + "bn2." + v] for v in
            ("weight", "bias", "running_mean", "running_var")] == \
        ["norm", "bias", "bias", "norm"]
    assert roles["encoder.localconv.weight"] == "other"


def test_published_size():
    """43.1 M parameters, 105 convolutions, dilations 1, 2 and 4."""
    cfg = _cfg(R101)
    keys = weights.coarse_keys(cfg)
    assert sum(torch.Size(s).numel() for _, s, _ in keys) == 43_129_792
    assert sum(k.endswith("conv1.weight") or k.endswith("conv2.weight")
               or k.endswith("conv3.weight") or "downsample.0" in k
               or k.endswith("localconv.weight") for k, _, _ in keys) == 105
    blocks = family.load(cfg["coarse"]).blocks(cfg["coarse"])
    assert [b[4] for b in blocks] == [1] * 7 + [1] + [2] * 22 + [2, 4, 4]
    assert [b[3] for b in blocks if b[3] != 1] == [2]  # layer2's first


def test_dilations_must_keep_the_previous_one():
    sec = dict(_cfg(R101)["coarse"], dilations=[[1, 1], [1, 1], [1, 2],
                                                [4, 4]])
    with pytest.raises(ValueError, match="layer4"):
        family.load(sec).keys(sec, "")


def test_patch_size_times_the_grid_is_the_input():
    """The output stride is the configuration's ``patch_size``, and 672
    is a multiple of it, so the reference's resize to ``input_size //
    patch_size * patch_size`` is none and the map is 84 x 84."""
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg

    c = _cfg(R101)["coarse"]
    with torch.device("meta"):
        module = FewShotSeg(c["input_size"], c["model"])
    grid = module.feature_hw
    assert grid == 84 and grid * c["patch_size"] == c["input_size"]
    fam = family.load(c)
    strides = 4 * torch.tensor([b[3] for b in fam.blocks(c)]).prod()
    assert int(strides) == c["patch_size"]
    assert fam.tokens(c) == 0


def test_forward_matches_the_ports_f32():
    """At the tiny size, the family's float32 forward and the port's f32
    encoder on the same drawn weights agree to float32 rounding (1e-5
    relative L2; bf16 would read ~1e-2), as (B, g², 256) tokens."""
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg

    cfg = _cfg(TINY_R)
    c = cfg["coarse"]
    wc, _ = weights.state_dicts(cfg, 2**31 + 7, "cpu")
    model = FewShotSeg(c["input_size"], cfg["program"]["modelname"]).eval()
    model.load_state_dict(wc)
    g = torch.Generator().manual_seed(3)
    x = F.interpolate(torch.randn(2, 3, 21, 21, generator=g),
                      size=(c["input_size"],) * 2, mode="bilinear",
                      align_corners=False) * 3.0
    with torch.no_grad():
        got = model.get_features(x)
    want = family.load(c).forward(weights.strip(wc, "encoder."), x, c)
    assert want.shape == (2, 32 * 32, 256)
    got = got.flatten(2).transpose(1, 2)
    gap = float((got - want).norm() / want.norm())
    assert gap <= 1e-5, gap


def test_flops_by_hand():
    """One 672-px image, 2 FLOP a multiply-add of every convolution: the
    stem at 336², layer1 at 168², layer2 from 168² to 84², layer3 and
    layer4 at 84² (dilated), the localconv: 618.07 GFLOP; 1.56 TFLOP with
    SAM-B's stages a slice."""
    def conv(side, cin, cout, k):
        return 2 * side * side * cin * cout * k * k

    def bottleneck(side_in, side, cin, planes, down):
        f = conv(side_in, cin, planes, 1) + conv(side, planes, planes, 3) \
            + conv(side, planes, 4 * planes, 1)
        return f + (conv(side, cin, 4 * planes, 1) if down else 0)

    want = {
        "resnet stem": conv(336, 3, 64, 7),
        "resnet layer1": bottleneck(168, 168, 64, 64, True)
        + 2 * bottleneck(168, 168, 256, 64, False),
        "resnet layer2": bottleneck(168, 84, 256, 128, True)
        + 3 * bottleneck(84, 84, 512, 128, False),
        "resnet layer3": bottleneck(84, 84, 512, 256, True)
        + 22 * bottleneck(84, 84, 1024, 256, False),
        "resnet layer4": bottleneck(84, 84, 1024, 512, True)
        + 2 * bottleneck(84, 84, 2048, 512, False),
        "resnet localconv": conv(84, 2048, 256, 1),
    }
    cfg = _cfg(R101)
    got = family.load(cfg["coarse"]).flops(cfg["coarse"])
    assert got == want
    assert {k: round(v / 1e9, 2) for k, v in got.items()} == {
        "resnet stem": 2.12, "resnet layer1": 12.02, "resnet layer2": 18.5,
        "resnet layer3": 367.16, "resnet layer4": 210.86,
        "resnet localconv": 7.4}
    coarse, sam = roofline.slice_flops(cfg)
    assert coarse / 1e9 == pytest.approx(618.07, abs=5e-3)
    assert (coarse + sam) / 1e12 == pytest.approx(1.5635, abs=1e-4)


# ------------------------------------------------------------- tiny cell


def _add_cell(root):
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_r", "source": "t",
                         "file": "benchmark/configs/tiny_r.json",
                         "reduced": [], "why": "t"})
    b["workloads"].append({"name": "t.rvol", "config": "tiny_r",
                           "traffic": "vol", "chips": 1, "why": "t"})
    b["end_to_end"][0]["workloads"].append("t.rvol")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def _bn_eps(pipe):
    """Every BatchNorm of the built program at eps 1e-3."""
    from protosam_tpu_torch.models.backbones.resnet import FrozenBatchNorm

    for m in pipe.coarse_model.encoder.modules():
        if isinstance(m, FrozenBatchNorm):
            m.eps = 1e-3


def _relu_before_add(pipe):
    """Each bottleneck's last ReLU before its residual add."""
    from protosam_tpu_torch.models.backbones.resnet import Bottleneck

    for m in pipe.coarse_model.encoder.modules():
        if isinstance(m, Bottleneck):
            def forward(x, b=m):
                out = F.relu(b.bn1(b.conv1(x)))
                out = F.relu(b.bn2(b.conv2(out)))
                out = F.relu(b.bn3(b.conv3(out)))
                return out + (x if b.downsample is None else b.downsample(x))
            m.forward = forward


@pytest.mark.parametrize("fault", [None, _bn_eps, _relu_before_add],
                         ids=["program", "bn_eps_1e-3", "relu_before_add"])
def test_tiny_resnet_cell(monkeypatch, tmp_path, fault):
    """The tiny dilated-ResNet configuration's cell, added by files and
    manifest entries, runs correct on the port's ResNet; with a planted
    fault in the program it does not, by ``feat_nsr``."""
    root = make_root(tmp_path)
    _add_cell(root)
    res, lines, earlier = run(monkeypatch, root, "t.rvol", hooks=fault)
    assert res["correct"] == (fault is None), lines
    assert earlier[1]["traffic"]["slices"] > 0
    v = res["checks"]["feat_nsr"]
    assert (v["value"] > v["limit"]) == (fault is not None), lines


# ------------------------------------------------------------ resnet_mfu


def _measured(cfg, calls, traced=True, **kw):
    base = dict(cfg=cfg, mix={"driver": "volumes"}, setup_s=10.0,
                window_s=2.0, calls=calls, slices=8, summary={},
                layer_ms={"coarse": 1000.0},
                trace=Trace([], 1e6, 0.6e6, []) if traced else None,
                host_spans=[], call_spans=[])
    base.update(kw)
    return cell.Measured(**base)


def _volumes(rec, images_each, span="resnet.encode"):
    """One ``pipeline.volume`` span a list, with an encode span for each
    of its image counts, each over its six stage spans."""
    for images in images_each:
        with rec.span("pipeline.volume"):
            for b in images:
                with rec.span(span, images=b, convs=105, feature_hw=84):
                    for _ in range(6):
                        with rec.span("resnet.stage"):
                            pass


@pytest.fixture
def ring(monkeypatch):
    from protosam_tpu_torch.utils import profiling

    rec = profiling.Recorder(capacity=256)
    monkeypatch.setattr(profiling, "spans", rec.spans)
    monkeypatch.setattr(profiling, "dropped", rec.dropped)
    return rec


def test_resnet_mfu_reads_the_windows_volumes(ring):
    """The warm call, two window volumes and the traced tail's two: only
    the window's 1 + 4 + 4 and 1 + 4 images count, over 1 s of coarse
    device time."""
    cfg = _cfg(R101)
    coarse, _ = roofline.slice_flops(cfg)
    _volumes(ring, [[1, 4, 4]])                    # warm
    _volumes(ring, [[1, 4, 4], [1, 4]])            # window
    _volumes(ring, [[1, 4], [1, 4, 4, 4]])         # traced tail
    m = _measured(cfg, calls=2)
    got = cell.read_metric("resnet_mfu", m)
    assert got == pytest.approx(100 * 14 * coarse / 989e12)
    # untraced: no tail, the newest two volumes are the window's
    ring.clear()
    _volumes(ring, [[1, 4, 4], [1, 4]])
    assert cell.read_metric("resnet_mfu", _measured(
        cfg, calls=2, traced=False)) == pytest.approx(got)


def test_resnet_mfu_is_none_without_its_spans(ring):
    cfg = _cfg(R101)
    m = _measured(cfg, calls=2)
    # a program without resnet.encode spans (the parent's), or a DINOv2
    # configuration's
    for _ in range(4):
        with ring.span("pipeline.volume"):
            pass
    assert cell.read_metric("resnet_mfu", m) is None
    ring.clear()
    _volumes(ring, [[1, 4], [1, 4], [1, 4], [1, 4]], span="dinov2.encode")
    assert cell.read_metric("resnet_mfu", m) is None
    # fewer volumes than the window and the tail hold
    ring.clear()
    _volumes(ring, [[1, 4], [1, 4]])
    assert cell.read_metric("resnet_mfu", m) is None
    # the ring overwrote spans of the window
    ring.clear()
    _volumes(ring, [[1, 4], [1] * 30, [1] * 10, [1, 4], [1, 4]])
    assert ring.dropped()
    assert cell.read_metric("resnet_mfu", m) is None
    # no coarse device time, the eval traffic
    assert cell.read_metric("resnet_mfu", _measured(cfg, 2, layer_ms={})) \
        is None
    assert cell.read_metric("resnet_mfu", _measured(
        cfg, 2, mix={"driver": "eval"})) is None
