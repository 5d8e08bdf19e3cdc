"""Parity of the port's ALPNet-only evaluation (``run_alpnet_eval``, with
and without test-time training) with the JAX package on the CPU, on the
synthetic CHAOS-T2 fold of ``tests/synthetic_data`` and the same seeded
weights; its NIfTI predictions, smoke cut and CLIs."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import protosam_tpu.eval.ttt as jttt
    from protosam_tpu.eval.alpnet_eval import \
        run_alpnet_eval as jrun_alpnet_eval
    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.utils.config import Config as JConfig
    from synthetic_data import HW, make_dataset
except ImportError:
    pass

from torch_parity import jax_coarse_params, seeded_state_dict

from protosam_tpu_torch.eval import alpnet_eval
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.utils.config import Config

torch.set_num_threads(2)
METRICS = ("classDice", "classPrec", "classRec")


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    data = make_dataset(str(tmp_path_factory.mktemp("chaos_eval")))
    sd = seeded_state_dict(FewShotSeg(image_size=HW,
                                      which_model="dinov2_t14"), 6)
    return data, sd, jax_coarse_params(sd)


def _cfg(cls, data, **kw):
    cfg = cls(dataset="CHAOST2", modelname="dinov2_t14",
              input_size=(HW, HW), dtype="float32", label_sets=0,
              support_idx=[-1], max_ccs=4, log_dir="", **kw)
    cfg.data_dirs = {"CHAOST2": data, "CHAOST2_Superpix": data}
    return cfg


def _jax(cfg, params):
    return jrun_alpnet_eval(cfg, model=JFewShotSeg(
        image_size=HW, which_model=cfg.modelname), params=params,
        write_preds=False)


def _gaps(ours, theirs):
    gaps = []
    for k in METRICS:
        assert ours[k].keys() == theirs[k].keys()
        for c, v in theirs[k].items():
            if np.isnan(v):
                assert np.isnan(ours[k][c])
            else:
                gaps.append(abs(ours[k][c] - v))
    return gaps


@pytest.mark.parametrize("do_cca", [True, False])
def test_alpnet_eval_matches_jax(fold, do_cca):
    data, sd, params = fold
    want = _jax(_cfg(JConfig, data, do_cca=do_cca), params)
    got = alpnet_eval.run_alpnet_eval(_cfg(Config, data, do_cca=do_cca),
                                      state_dict=sd, write_preds=False,
                                      device="cpu")
    assert max(_gaps(got, want)) <= 1e-6
    assert got["meanDice"] == pytest.approx(want["meanDice"], abs=1e-6)


def _two_steps(mod, mp):
    real = mod.test_time_training
    mp.setattr(mod, "test_time_training", lambda *a, **k: real(
        *a, **dict(k, n_steps=2)))


@pytest.fixture(scope="module")
def jax_ttt(fold):
    """JAX's eval with test-time training, 2 steps a slice."""
    data, _, params = fold
    with pytest.MonkeyPatch.context() as mp:
        _two_steps(jttt, mp)
        return _jax(_cfg(JConfig, data, ttt=True), params)


def test_alpnet_eval_with_ttt_matches_jax(fold, jax_ttt, monkeypatch):
    """Test-time training on every query slice (2 steps each on both
    sides, to keep the run short): per-class Dice within 1e-3."""
    data, sd, _ = fold
    _two_steps(alpnet_eval, monkeypatch)
    got = alpnet_eval.run_alpnet_eval(_cfg(Config, data, ttt=True),
                                      state_dict=sd, write_preds=False,
                                      device="cpu")
    for c, v in jax_ttt["classDice"].items():
        assert abs(got["classDice"][c] - v) <= 1e-3


def test_ttt_restores_the_weights_after_each_slice(fold, monkeypatch):
    data, sd, _ = fold
    calls = []
    real = alpnet_eval.test_time_training

    def ttt(model, *a, **k):
        calls.append({n: v.clone() for n, v in model.state_dict().items()})
        return real(model, *a, **dict(k, n_steps=1))

    monkeypatch.setattr(alpnet_eval, "test_time_training", ttt)
    cfg = _cfg(Config, data, ttt=True)
    model = alpnet_eval.build_coarse_model(cfg, "cpu", sd)
    alpnet_eval.run_alpnet_eval(cfg, model=model, write_preds=False,
                                max_slices=3)
    assert len(calls) == 6
    for before in calls:  # every slice starts from the weights loaded
        assert all(torch.equal(v, sd[n]) for n, v in before.items())
    assert all(torch.equal(v, sd[n]) for n, v in model.state_dict().items())


def test_alpnet_eval_writes_predictions_and_cuts(fold, tmp_path):
    from protosam_tpu_torch.data.nifti import read_nii

    data, sd, _ = fold
    cfg = _cfg(Config, data, do_cca=True)
    cfg.log_dir = str(tmp_path)
    res = alpnet_eval.run_alpnet_eval(cfg, state_dict=sd, device="cpu",
                                      max_slices=2)
    assert set(res["classDice"]) == {"2", "3"}
    out = tmp_path / "interm_preds"
    files = sorted(p.name for p in out.iterdir())
    assert files and all(f.endswith(".nii.gz") for f in files)
    vol = read_nii(str(out / files[0]))
    assert vol.shape[1:] == (HW, HW)


def test_clis_parse_the_sacred_surface(monkeypatch):
    from protosam_tpu_torch import training, validation

    seen = {}
    monkeypatch.setattr(validation, "run_alpnet_eval",
                        lambda cfg: seen.setdefault("eval", cfg) and {})
    monkeypatch.setattr(training, "train", lambda cfg: seen.setdefault(
        "train", cfg) and {"step": 0})
    argv = ["with", "modelname=dinov2_l14", "input_size=(672, 672)",
            "ttt=True", "lr=0.002", "path.log_dir=runs/x"]
    validation.main(argv)
    training.main(argv)
    for cfg in seen.values():
        assert (cfg.modelname, cfg.input_size, cfg.ttt, cfg.lr,
                cfg.log_dir) == ("dinov2_l14", (672, 672), True, 0.002,
                                 "runs/x")
