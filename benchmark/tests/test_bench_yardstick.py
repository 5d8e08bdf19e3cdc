"""The benchmark's frozen copies against the port at the sizes where the
two must agree, or against hand values; its imports; its traffic's
determinism in the seed."""

from __future__ import annotations

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.harness import cell, family, roofline, synth, trace, weights
from benchmark.harness.trace import Op, Span, Trace

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "protosam_tpu"}


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_imports_no_jax(path):
    """Top-level names compared whole: ``protosam_tpu_torch`` is the
    program, ``protosam_tpu`` the JAX package; the reference and the model
    families import nothing of the program."""
    found = _imports(path)
    assert not found & FORBIDDEN, found
    if {"reference", "families"} & set(path.relative_to(BENCH).parts):
        assert "protosam_tpu_torch" not in found, found


PUBLISHED = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def _config(name: str) -> dict:
    path = BENCH / ("tests/tiny/configs" if name == "tiny" else "configs")
    return json.loads((path / f"{name}.json").read_text())


@pytest.mark.parametrize("name", PUBLISHED)
def test_flop_counts_match_the_port(name):
    """Each published configuration's families count what the port's
    ``tools/roofline.py`` counts for the same models."""
    from protosam_tpu_torch.tools import roofline as port

    cfg = _config(name)
    c, s = cfg["coarse"], cfg["sam"]
    assert family.load(c).flops(c) == port.dino_flops(
        cfg["program"]["modelname"], c["input_size"])
    assert family.load(s).flops(s) == port.sam_flops(
        s["model"], s["image_size"], s["window_size"])
    dino, sam = roofline.slice_flops(cfg)
    assert (dino, sam) == (sum(family.load(c).flops(c).values()),
                           sum(family.load(s).flops(s).values()))


def test_kernel_counts_match_the_port():
    from protosam_tpu_torch.tools import roofline as port

    for label, (name, shapes) in port.MAIN_PATH_SHAPES.items():
        assert roofline.kernel_cost(name, **shapes) == \
            port.kernel_cost(name, **shapes), label


def test_flop_counts_by_hand():
    # K2 at DINOv2-L 672, 4 slices: 4·b·nh·s·n_valid·hd
    flops, nbytes, ms, by = roofline.kernel_cost(
        "packed_masked_attention", b=4, s=2432, nh=16, hd=64, n_valid=2305)
    assert flops == 4 * 4 * 16 * 2432 * 2305 * 64
    assert nbytes == 4 * 2432 * 4 * 1024 * 2
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    cfg = json.loads((BENCH / "configs/protosam_l14_vith.json").read_text())
    dino, sam = roofline.slice_flops(cfg)
    assert dino / 1e12 == pytest.approx(2.0227, abs=1e-4)
    assert sam / 1e12 == pytest.approx(5.6684, abs=1e-4)


def _measured(cfg, ops=(), **kw):
    tr = Trace(list(ops), 1e6, 0.6e6, [])
    base = dict(cfg=cfg, mix={"driver": "volumes"},
                setup_s=10.0, window_s=2.0, calls=2, slices=40, summary={},
                layer_ms={"coarse": 400.0}, trace=tr, host_spans=[],
                call_spans=[])
    base.update(kw)
    return cell.Measured(**base)


def test_metric_readers_by_hand():
    cfg = json.loads((BENCH / "configs/protosam_l14_vitb.json").read_text())
    dino, sam = roofline.slice_flops(cfg)
    m = _measured(cfg)
    mfu = cell.read_metric("pipeline_mfu", m)
    assert mfu == pytest.approx(100 * (40 * (dino + sam) + 2 * dino)
                                / (2.0 * 989e12))
    assert cell.read_metric("slices_per_s", m) == 20.0
    assert cell.read_metric("coarse_ms_per_slice", m) == 10.0
    assert cell.read_metric("prompts_ms_per_slice", m) is None
    assert cell.read_metric("device_idle", m) == pytest.approx(40.0)
    assert cell.read_metric("eval_host_share", m) is None
    # K2: one launch at b = 4 taking twice its bound reads 50%
    _, _, ms, _ = roofline.kernel_cost(
        "packed_masked_attention", b=4, s=2432, nh=16, hd=64, n_valid=2305)
    span = Span("bench.coarse/get_features[b=4]", 0.0, 10.0, 0)
    k2 = Op("void packed_kernel<64>(Args)", "kernel", 1.0, 2 * ms * 1e3,
            span)
    other = Op("void packed_kernel<64>(Args)", "kernel", 5.0, 1.0, None)
    m = _measured(cfg, ops=[k2, other])
    assert cell.read_metric("k2_roofline", m) == pytest.approx(50.0)
    assert cell.read_metric("k4_roofline", m) is None
    # K4: a ViT-B encode at b = 1, every block at its bound reads 100%
    span = Span("bench.sam_encoder/encode_image[b=1]", 0.0, 99.0, 1)
    ops = []
    for j in range(12):
        g = j in (2, 5, 8, 11)
        _, _, ms, _ = roofline.kernel_cost(
            "relpos_patch_attention", b=1, hp=64 if g else 70,
            wp=64 if g else 70, nh=12, hd=64, patch=64 if g else 14)
        ops.append(Op("relpos_kernel<64, true>", "kernel", float(j),
                      ms * 1e3, span))
    m = _measured(cfg, ops=ops)
    assert cell.read_metric("k4_roofline", m) == pytest.approx(100.0)
    m = _measured(cfg, mix={"driver": "eval"}, call_spans=[(0.0, 4.0)],
                  host_spans=[(0.5, 1.5), (2.0, 3.0)], window_s=4.0,
                  slices=80)
    assert cell.read_metric("eval_host_share", m) == pytest.approx(50.0)
    assert cell.read_metric("eval_slices_per_s", m) == 20.0
    assert cell.read_metric("device_idle.eval", m) == pytest.approx(40.0)
    assert cell.read_metric("device_idle", m) is None


def test_trace_parse_by_hand():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation",
         "name": "bench.coarse/get_features[b=4]", "ts": 1, "dur": 20},
        {"ph": "X", "cat": "user_annotation",
         "name": "bench.prompts/_extract_prompts[b=4]", "ts": 30, "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 20,
         "dur": 40, "args": {}},
    ]
    tr = trace.parse(ev)
    assert tr.window_us == 100 and tr.busy_us == 50
    assert tr.ops[0].span.name == "bench.coarse/get_features[b=4]"
    assert tr.ops[1].span is None
    # idle 0-10 (host in get_features from 1), 60-100 (host in prompts)
    assert sorted(tr.gaps) == [(10, "unspanned"), (40, "bench.prompts/"
                                                     "_extract_prompts[b=4]")]
    assert trace.union_us([(0, 2), (1, 3), (5, 6)], 0, 10) == 4


@pytest.mark.parametrize("name", PUBLISHED + ["tiny"])
@pytest.mark.parametrize("section", ["coarse", "sam"])
def test_weight_layout_is_the_programs(name, section):
    """Each family's published layout, at each configuration's sizes,
    loads strictly into the program's model (same keys, same shapes), and
    its roles are the program's own recipe's
    (``utils/synthetic.synthetic_state_dict``)."""
    from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
    from protosam_tpu_torch.models.sam.registry import build_sam
    from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

    cfg = _config(name)
    with torch.device("meta"):
        if section == "coarse":
            module = FewShotSeg(cfg["coarse"]["input_size"],
                                cfg["program"]["modelname"])
            keys = weights.coarse_keys(cfg)
        else:
            module = build_sam(cfg["sam"]["model"], cfg["sam"]["image_size"])
            keys = weights.sam_keys(cfg)
    sd = module.state_dict()
    assert {k: tuple(s) for k, s, _ in keys} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    if name != "tiny":
        return
    ref = synthetic_state_dict(module, 0)
    for k, _, role in keys:
        mean = float(ref[k].mean())
        want = {"norm": 1.0, "bias": 0.0, "other": 0.0}[role]
        assert abs(mean - want) < 0.05, (k, role, mean)
        if role == "other":
            assert float(ref[k].std()) > 0.005 or ref[k].numel() < 4, k


def test_weights_follow_the_recipe():
    cfg = json.loads((BENCH / "tests/tiny/configs/tiny.json").read_text())
    a, b = weights.state_dicts(cfg, 2**31 + 5, "cpu")
    a2, _ = weights.state_dicts(cfg, 2**31 + 5, "cpu")
    c, _ = weights.state_dicts(cfg, 6, "cpu")
    assert all(torch.equal(a[k], a2[k]) for k in a)
    assert not torch.equal(a["encoder.pos_embed"], c["encoder.pos_embed"])
    roles = {k: r for k, _, r in weights.coarse_keys(cfg)}
    for k, v in a.items():
        if roles[k] == "bias":
            assert not v.any()
        elif roles[k] == "norm":
            assert abs(float(v.mean()) - 1) < 0.01
        else:
            assert float(v.std()) == pytest.approx(0.02, rel=0.2) \
                or v.numel() < 100


def test_synthetic_inputs_match_the_port_recipe():
    """``smooth_slices`` is ``utils/synthetic.smooth_volume``'s recipe on
    the same field; ``support`` its square label."""
    from protosam_tpu_torch.ops.resize import resize_bilinear
    from protosam_tpu_torch.utils.synthetic import synthetic_episode

    g = synth.generator(3, "cpu")
    field = torch.randn(2, 3, 21, 21, generator=synth.generator(3, "cpu"))
    ours = synth.smooth_slices(2, 64, g, "cpu")
    torch.testing.assert_close(ours, resize_bilinear(field, (64, 64)) * 3.0)
    _, lbl = synth.support(90, synth.generator(1, "cpu"), "cpu")
    assert torch.equal(lbl, synthetic_episode(90, "cpu", 0).fore_mask)


def test_traffic_is_deterministic_in_the_seed(tmp_path):
    from benchmark.drivers.volumes import Driver

    cfg = json.loads((BENCH / "tests/tiny/configs/tiny.json").read_text())
    mix = {"driver": "volumes", "depths": [3, 5, 7], "slice_batch": 2}
    big = 2**31 + 11
    a, b, c = (Driver(cfg, mix, s, "cpu") for s in (big, big, 12))
    assert a.check_calls == b.check_calls
    assert [a._index(i) for i in range(9)] == [b._index(i) for i in range(9)]
    for (qa, sa, la), (qb, sb, lb) in zip(a.pool, b.pool):
        assert torch.equal(qa, qb) and torch.equal(sa, sb)
    # every seed runs the same depths, in its own order and content
    assert sorted(q.shape[0] for q, _, _ in c.pool) == [3, 5, 7]
    assert not torch.equal(a.pool[0][0], c.pool[0][0])
    for seed, sub in ((big, "x"), (big, "y"), (12, "z")):
        synth.write_fold(str(tmp_path / sub), [1, 2], 6, 64, seed)
    same = lambda f: (tmp_path / "x" / f).read_bytes() == \
        (tmp_path / "y" / f).read_bytes()
    assert all(same(f) for f in ("image_1.nii.gz", "label_2.nii.gz",
                                 "classmap_1.json"))
    assert (tmp_path / "x/image_1.nii.gz").read_bytes() != \
        (tmp_path / "z/image_1.nii.gz").read_bytes()


def test_fold_reads_back_through_both_readers(tmp_path):
    """The fold writer's files read the same through the program's NIfTI
    reader and the reference's."""
    from protosam_tpu_torch.data.nifti import read_nii

    from benchmark.reference.data import read_nifti

    out = synth.write_fold(str(tmp_path), [1], 5, 48, 3)
    assert out["bytes"] > 0 and out["raw_bytes"] == 5 * 48 * 48 * 6
    for f in ("image_1.nii.gz", "label_1.nii.gz"):
        ours = read_nifti(str(tmp_path / f))
        theirs = read_nii(str(tmp_path / f))
        assert ours.shape == (5, 48, 48)
        np.testing.assert_array_equal(ours, theirs)
    cmap = json.loads((tmp_path / "classmap_1.json").read_text())
    assert set(cmap) == set(synth.FOLD_NAMES) and cmap["RK"]["1"]
