"""DINOv2 ViT-g/14's model family (``families/dinov2_g14.py``) against the
port and hand counts, the tiny gated cell end to end on the CPU, and the
``coarse_mfu`` reader on hand-made spans."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from benchmark.harness import cell, family, roofline, weights
from benchmark.harness.trace import Trace

from bench_tiny import make_root, run

BENCH = pathlib.Path(__file__).resolve().parents[1]
TINY_G = BENCH / "tests/tiny/configs/tiny_g.json"
G14 = BENCH / "configs/protosam_g14_vitb.json"


def _cfg(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", [G14, TINY_G], ids=["published", "tiny"])
def test_keys_are_the_ports(path):
    """The family's layout loads strictly into the port's model: the same
    keys and shapes as its ``state_dict``, the FFN as w12 / w3."""
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg

    cfg = _cfg(path)
    with torch.device("meta"):
        module = FewShotSeg(cfg["coarse"]["input_size"],
                            cfg["program"]["modelname"])
    keys = weights.coarse_keys(cfg)
    assert {k: tuple(s) for k, s, _ in keys} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    c, h = cfg["coarse"]["embed_dim"], cfg["coarse"]["ffn_hidden"]
    shapes = {k: s for k, s, _ in keys}
    assert shapes["encoder.blocks.0.mlp.w12.weight"] == (2 * h, c)
    assert shapes["encoder.blocks.0.mlp.w3.weight"] == (c, h)


def test_ffn_hidden_must_be_the_hubs():
    sec = dict(_cfg(G14)["coarse"], ffn_hidden=4100)
    with pytest.raises(ValueError, match="4096"):
        family.load(sec).keys(sec, "")


def test_forward_matches_the_ports_f32():
    """At the tiny size, the family's float32 forward and the port's f32
    encoder on the same drawn weights agree to float32 rounding (1e-5
    relative L2; bf16 would read ~1e-2)."""
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg

    cfg = _cfg(TINY_G)
    c = cfg["coarse"]
    wc, _ = weights.state_dicts(cfg, 2**31 + 7, "cpu")
    model = FewShotSeg(c["input_size"], cfg["program"]["modelname"]).eval()
    model.load_state_dict(wc)
    g = torch.Generator().manual_seed(3)
    x = torch.nn.functional.interpolate(
        torch.randn(2, 3, 21, 21, generator=g), size=(112, 112),
        mode="bilinear", align_corners=False) * 3.0
    with torch.no_grad():
        got = model.encoder(x)["x_norm_patchtokens"]
    want = family.load(c).forward(weights.strip(wc, "encoder."), x, c)
    gap = float((got - want).norm() / want.norm())
    assert gap <= 1e-5, gap


def test_flops_by_hand():
    """One 672-px image: 40 blocks over the 2432-row padded sequence of
    2305 tokens, qkv and proj (4·C²) and the gated FFN (3·h·C) a token,
    attention QKᵀ + PV against the real keys, the patch convolution: 6.89
    TFLOP; 7.84 with SAM-B's stages a slice."""
    cfg = _cfg(G14)
    c, h, s, n, depth = 1536, 4096, 2432, 2305, 40
    dense = 2 * s * (4 * c * c + 3 * h * c) * depth
    attn = 4 * s * n * 64 * 24 * depth
    conv = 2 * 48 * 48 * (14 * 14 * 3) * c
    fl = family.load(cfg["coarse"]).flops(cfg["coarse"])
    assert fl == {"dinov2 dense gemms": dense + conv,
                  "dinov2 attention": attn}
    dino, sam = roofline.slice_flops(cfg)
    assert dino / 1e12 == pytest.approx(6.8901, abs=1e-4)
    assert (dino + sam) / 1e12 == pytest.approx(7.8356, abs=1e-4)
    assert family.load(cfg["coarse"]).tokens(cfg["coarse"]) == n


def _add_cell(root):
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_g", "source": "t",
                         "file": "benchmark/configs/tiny_g.json",
                         "reduced": [], "why": "t"})
    b["workloads"].append({"name": "t.gvol", "config": "tiny_g",
                           "traffic": "vol", "chips": 1, "why": "t"})
    b["end_to_end"][0]["workloads"].append("t.gvol")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def _swap_gate(pipe):
    """x1 and x2 swapped in every gated block of the built program."""
    import torch.nn.functional as F

    for blk in pipe.coarse_model.encoder.blocks:
        mlp = blk.mlp

        def swapped(x, mlp=mlp):
            x1, x2 = mlp.w12(x).chunk(2, dim=-1)
            return mlp.w3(F.silu(x2) * x1)
        mlp.forward = swapped


@pytest.mark.parametrize("fault", [False, True])
def test_tiny_gated_cell(monkeypatch, tmp_path, fault):
    """The tiny gated configuration's cell, added by files and manifest
    entries, runs correct on the port's gated DINOv2; with x1 and x2
    swapped in the program it does not."""
    root = make_root(tmp_path)
    _add_cell(root)
    res, lines, earlier = run(monkeypatch, root, "t.gvol",
                              hooks=_swap_gate if fault else None)
    assert res["correct"] != fault, lines
    assert earlier[1]["traffic"]["slices"] > 0
    if fault:
        v = res["checks"]["feat_nsr"]
        assert v["value"] > v["limit"], lines


# ----------------------------------------------------------- coarse_mfu


def _measured(cfg, calls, traced=True, **kw):
    base = dict(cfg=cfg, mix={"driver": "volumes"}, setup_s=10.0,
                window_s=2.0, calls=calls, slices=8, summary={},
                layer_ms={"coarse": 1000.0},
                trace=Trace([], 1e6, 0.6e6, []) if traced else None,
                host_spans=[], call_spans=[])
    base.update(kw)
    return cell.Measured(**base)


def _volumes(rec, images_each):
    """One ``pipeline.volume`` span a list, with a ``dinov2.encode`` span
    for each of its image counts."""
    for images in images_each:
        with rec.span("pipeline.volume"):
            for b in images:
                with rec.span("dinov2.encode", images=b):
                    pass


@pytest.fixture
def ring(monkeypatch):
    from protosam_tpu_torch.utils import profiling

    rec = profiling.Recorder(capacity=64)
    monkeypatch.setattr(profiling, "spans", rec.spans)
    monkeypatch.setattr(profiling, "dropped", rec.dropped)
    return rec


def test_coarse_mfu_reads_the_windows_volumes(ring):
    """The warm call, two window volumes and the traced tail's two: only
    the window's 1 + 4 + 4 and 1 + 4 images count, over 1 s of coarse
    device time."""
    cfg = _cfg(G14)
    dino, _ = roofline.slice_flops(cfg)
    _volumes(ring, [[1, 4, 4]])                    # warm
    _volumes(ring, [[1, 4, 4], [1, 4]])            # window
    _volumes(ring, [[1, 4], [1, 4, 4, 4]])         # traced tail
    m = _measured(cfg, calls=2)
    got = cell.read_metric("coarse_mfu", m)
    assert got == pytest.approx(100 * 14 * dino / 989e12)
    # untraced: no tail, the newest two volumes are the window's
    ring.clear()
    _volumes(ring, [[1, 4, 4], [1, 4]])
    assert cell.read_metric("coarse_mfu", _measured(
        cfg, calls=2, traced=False)) == pytest.approx(got)


def test_coarse_mfu_is_none_without_its_spans(ring):
    cfg = _cfg(G14)
    m = _measured(cfg, calls=2)
    # a program without dinov2.encode spans (the parent's)
    for _ in range(4):
        with ring.span("pipeline.volume"):
            pass
    assert cell.read_metric("coarse_mfu", m) is None
    # fewer volumes than the window and the tail hold
    ring.clear()
    _volumes(ring, [[1, 4], [1, 4]])
    assert cell.read_metric("coarse_mfu", m) is None
    # the ring overwrote spans of the window
    ring.clear()
    _volumes(ring, [[1, 4], [1] * 50, [1] * 10, [1, 4], [1, 4]])
    assert ring.dropped()
    assert cell.read_metric("coarse_mfu", m) is None
    # no coarse device time, the eval traffic
    assert cell.read_metric("coarse_mfu", _measured(cfg, 2, layer_ms={})) \
        is None
    assert cell.read_metric("coarse_mfu", _measured(
        cfg, 2, mix={"driver": "eval"})) is None
