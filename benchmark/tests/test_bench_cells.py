"""The harness end to end on the CPU at the tiny size: the reference
agrees with the program, the last line's format, files found by name, the
control and planted faults come out not correct."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import cell, family

from bench_tiny import make_root, run

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["t.vol", "t.ev"])
def test_program_agrees_with_the_reference(monkeypatch, root, name):
    res, lines, earlier = run(monkeypatch, root, name)
    assert res["correct"], lines
    # the f32 program and the f32 reference agree to rounding
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"], (k, v)
    assert list(res) == RESULT_KEYS
    assert list(res["checks"]) == [ln.split()[0] for ln in lines]
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    rate = "slices_per_s" if name == "t.vol" else "eval_slices_per_s"
    assert set(res["metrics"]) == {rate, "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    json.dumps(res)
    assert earlier[1]["traffic"]["slices"] > 0


def test_added_files_are_found_by_name(monkeypatch, root):
    """A new configuration, mix, limits, metric and cell enter by new
    files and manifest entries alone."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    for sub, old, new in (("configs", "tiny", "tiny2"),
                          ("traffic", "vol", "vol2"),
                          ("limits", "t.vol", "t.vol2")):
        d = root / "benchmark" / sub
        (d / f"{new}.json").write_text((d / f"{old}.json").read_text())
    mix = json.loads((root / "benchmark/traffic/vol2.json").read_text())
    mix["depths"] = [2]
    (root / "benchmark/traffic/vol2.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/calls_seen.py").write_text(
        "def read(m):\n    return float(m.calls)\n")
    b["configs"].append({"name": "tiny2", "source": "t",
                         "file": "benchmark/configs/tiny2.json",
                         "reduced": [], "why": "t"})
    b["workloads"].append({"name": "t.vol2", "config": "tiny2",
                           "traffic": "vol2", "chips": 1, "why": "t"})
    b["end_to_end"][0]["workloads"].append("t.vol2")
    b["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["t.vol2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res, _, earlier = run(monkeypatch, root, "t.vol2")
    assert res["correct"]
    assert res["metrics"]["calls_seen"]["value"] >= 1
    assert earlier[1]["traffic"]["depths"] == {2: res["attempted"]}


# DINOv2 with registers as the hub's ``_reg`` models have them (4 tokens
# after the cls token, the position grid resized antialiased in size mode)
REG_FAMILY = '''
from benchmark.families import dinov2

def keys(sec, prefix):
    return dinov2.keys(sec, prefix, registers=4)

def forward(w, x, sec):
    return dinov2.forward(w, x, sec, registers=4, offset=0.0,
                          antialias={antialias})

def tokens(sec):
    return dinov2.tokens(sec, registers=4)

def flops(sec):
    return dinov2.flops(sec, registers=4)
'''


@pytest.mark.parametrize("fault", [False, True])
def test_a_family_added_by_file_is_found_by_name(monkeypatch, tmp_path,
                                                 fault):
    """A configuration whose coarse family exists only as a file added to
    the root runs correct on the program's tiny DINOv2 given registers;
    the same family with a fault planted in its ``forward`` (the position
    grid resized without antialiasing) does not."""
    from protosam_tpu_torch.models.alpnet import fewshot
    from protosam_tpu_torch.models.dinov2 import vit

    monkeypatch.setitem(vit._DINO_CONFIGS, "dinov2_vitt14_reg", dict(
        vit._DINO_CONFIGS["dinov2_vitt14"], num_register_tokens=4,
        interpolate_antialias=True, interpolate_offset=0.0))
    monkeypatch.setitem(fewshot._ENCODER_ALIASES, "dinov2_t14_reg",
                        "dinov2_vitt14_reg")
    root = make_root(tmp_path)
    (root / "benchmark/families/dinov2_reg.py").write_text(
        REG_FAMILY.format(antialias=not fault))
    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    cfg["coarse"]["family"] = "dinov2_reg"
    cfg["program"]["modelname"] = "dinov2_t14_reg"
    (root / "benchmark/configs/tiny_reg.json").write_text(json.dumps(cfg))
    (root / "benchmark/limits/t.reg.json").write_text(
        (root / "benchmark/limits/t.vol.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_reg", "source": "t",
                         "file": "benchmark/configs/tiny_reg.json",
                         "reduced": [], "why": "t"})
    b["workloads"].append({"name": "t.reg", "config": "tiny_reg",
                           "traffic": "vol", "chips": 1, "why": "t"})
    b["end_to_end"][0]["workloads"].append("t.reg")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    # 8² patches at 112 px, the cls token and 4 registers
    assert family.load(cfg["coarse"], root).tokens(cfg["coarse"]) == 69
    res, lines, _ = run(monkeypatch, root, "t.reg")
    if not fault:
        assert res["correct"], lines
        return
    assert not res["correct"], lines
    v = res["checks"]["feat_nsr"]
    assert v["value"] > v["limit"], lines


def test_control_comes_out_not_correct(monkeypatch, root):
    """The program's int8 path, the precision below the configuration's,
    fails the cell's limits."""
    res, lines, _ = run(monkeypatch, root, "t.vol", variant="int8")
    assert not res["correct"], lines
    failed = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert failed & {"feat_nsr", "embed_nsr"}, lines


def _perturb_output(obj, name, edit):
    orig = getattr(obj, name)
    setattr(obj, name, lambda *a, **k: edit(orig(*a, **k)))


def _shift_box(ex):
    ex["boxes"] = ex["boxes"] + 3.0
    return ex


def _noisy_embedding(e):
    return e + 0.05 * e.std() * torch.randn_like(e)


def _flip_mask(out):
    preds, scores = out
    preds = preds.clone()
    preds[0, : preds.shape[1] // 2] = 1.0 - preds[0, : preds.shape[1] // 2]
    return preds, scores


FAULTS = {
    "scores": (lambda p: _perturb_output(p.coarse_model, "score",
                                         lambda x: x * 1.01), "alp_gap"),
    "embedding": (lambda p: _perturb_output(p.sam_model, "encode_image",
                                            _noisy_embedding), "embed_nsr"),
    "prompt": (lambda p: _perturb_output(p, "_extract_prompts", _shift_box),
               "prompt_px"),
    "answer": (lambda p: _perturb_output(p, "forward_volume", _flip_mask),
               "mask_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_an_altered_answer_is_not_correct(monkeypatch, root, fault):
    plant, number = FAULTS[fault]
    res, lines, _ = run(monkeypatch, root, "t.vol", hooks=plant)
    assert not res["correct"], lines
    v = res["checks"][number]
    assert v["value"] > v["limit"], lines


def test_altered_eval_metrics_are_not_correct(monkeypatch, root):
    from protosam_tpu_torch.eval import protosam_eval

    orig = protosam_eval.dice_iou_precision_recall

    def off(pred, gt):
        m = orig(pred, gt)
        m["dice"] += 1e-3
        return m

    monkeypatch.setattr(protosam_eval, "dice_iou_precision_recall", off)
    res, lines, _ = run(monkeypatch, root, "t.ev")
    assert not res["correct"], lines
    assert res["checks"]["metric_gap"]["value"] > 1e-9


def test_no_card_means_no_result(capsys):
    """run.py exits non-zero and prints no result line without a card."""
    import benchmark.run as entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    rc = entry.main(["--workload", "l14_vitb.volumes", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert "correct" not in capsys.readouterr().out


def test_manifest_names_match_files():
    b = cell.manifest()
    for w in b["workloads"]:
        cell.cell_files(b, w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert (cell.ROOT / "benchmark/metrics" / f"{m['name']}.py"
                ).exists(), m["name"]
    for conf in b["configs"]:
        cfg = json.loads((cell.ROOT / conf["file"]).read_text())
        for sec in (cfg["coarse"], cfg["sam"]):
            fam = family.load(sec)
            for fn in ("keys", "forward", "flops"):
                assert callable(getattr(fam, fn)), (sec["family"], fn)
