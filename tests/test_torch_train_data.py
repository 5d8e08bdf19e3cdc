"""Parity of the port's training data path with the JAX package on the
CPU: the cv2-free warp, blur and rotation matrix against cv2 (installed
here), ``transform_with_label`` and ``SuperpixelDataset`` episodes against
JAX's with the same seeds, and ``train()``'s history against JAX's at one
worker, with a resume from the snapshots."""

import sys

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import cv2
    import jax
    import jax.numpy as jnp

    from protosam_tpu.data import superpixel as jsuperpixel
    from protosam_tpu.data import transforms as jtransforms
    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.train import trainer as jtrainer
    from protosam_tpu.utils.config import Config as JConfig
    from synthetic_data import HW, make_dataset
except ImportError:
    pass

from protosam_tpu_torch.data import superpixel, transforms
from protosam_tpu_torch.train import trainer
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.convert import fewshot_state_dict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("chaos_train")))


# ------------------------------------------------------- the cv2 kernels


@pytest.mark.parametrize("cn", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("hw,aug", [((64, 64), "sabs_aug"),
                                    ((47, 70), "aug_v3")])
def test_warp_affine_matches_cv2(cn, hw, aug):
    """JAX warps with OpenCV flag 3 (INTER_AREA, bilinear in a warp) and a
    constant zero border: 1e-5 of the image range (it is bit-equal)."""
    rng = np.random.default_rng(cn)
    img = rng.standard_normal(hw + (cn,)).astype(np.float32)
    for seed in range(3):
        m = transforms.RandomAffine(
            *(lambda a: (a["rotate"], a["shift"], a["shear"], a["scale"]))(
                transforms.get_aug(aug, hw[0])["aug"]["affine"]),
            rng=np.random.RandomState(seed)).build_matrix(hw)[:2]
        want = cv2.warpAffine(img, m, hw[::-1], flags=3,
                              borderMode=cv2.BORDER_CONSTANT).reshape(img.shape)
        got = transforms.warp_affine(img, m)
        assert np.abs(got - want).max() <= 1e-5 * np.ptp(img)


def test_blur_and_rotation_matrix_match_cv2():
    rng = np.random.default_rng(0)
    for shape in ((64, 64), (37, 90)):
        x = rng.random(shape) * 2 - 1
        want = cv2.GaussianBlur(x, ksize=(21, 21), sigmaX=5)
        got = transforms.gaussian_blur(x, 21, 5)
        assert np.abs(got - want).max() <= 1e-5 * np.ptp(x)
    for center, deg, scale in (((32.0, 32), 17.3, 1.0), ((336.0, 336), -4.2,
                                                          1.13)):
        np.testing.assert_allclose(
            transforms.rotation_matrix_2d(center, deg, scale),
            cv2.getRotationMatrix2D(center, deg, scale), rtol=0, atol=1e-12)


@pytest.mark.parametrize("c_img,aug", [(1, "sabs_aug"), (3, "sabs_aug"),
                                       (1, "aug_v3")])
def test_transform_with_label_matches_jax(c_img, aug):
    """The same RandomState gives JAX's images (1e-5 of their range) and
    labels (equal), draw for draw."""
    rng = np.random.default_rng(c_img)
    comp = rng.standard_normal((HW, HW, c_img + 1)).astype(np.float32)
    comp[..., -1] = 0
    comp[20:40, 12:44, -1] = 1
    ours = transforms.transform_with_label(transforms.get_aug(aug, HW),
                                           rng=np.random.RandomState(3))
    theirs = jtransforms.transform_with_label(jtransforms.get_aug(aug, HW),
                                              rng=np.random.RandomState(3))
    for _ in range(3):
        for onehot in (False, True):
            a_img, a_lbl = ours(comp, c_label=1, c_img=c_img,
                                use_onehot=onehot, nclass=2)
            b_img, b_lbl = theirs(comp, c_label=1, c_img=c_img,
                                  use_onehot=onehot, nclass=2)
            assert np.abs(a_img - b_img).max() <= 1e-5 * np.ptp(b_img)
            assert np.array_equal(a_lbl, b_lbl)


def test_elastic_matches_jax():
    img = np.random.default_rng(5).random((HW, HW, 3)).astype(np.float32)
    for alpha, sigma in ((10, 5), (20, 5)):
        a = transforms.elastic_transform_nd(img, alpha, sigma,
                                            rng=np.random.RandomState(1))
        b = jtransforms.elastic_transform_nd(img, alpha, sigma,
                                             rng=np.random.RandomState(1))
        assert np.array_equal(a, b)


# ------------------------------------------------------ the episodes


def _datasets(data_dir, **kw):
    out = []
    for mod, tr in ((superpixel, transforms), (jsuperpixel, jtransforms)):
        out.append(mod.SuperpixelDataset(
            which_dataset="CHAOST2", base_dir=data_dir, idx_split=0,
            mode="train", image_size=HW,
            transforms=tr.transform_with_label(
                tr.get_aug("sabs_aug", HW), rng=np.random.RandomState(4)),
            seed=1, **kw))
    return out


@pytest.mark.parametrize("kw", [{}, {"use_3_slices": True},
                                {"exclude_list": [2, 3]}],
                         ids=["plain", "3_slices", "exclude"])
def test_superpixel_episodes_match_jax(data_dir, kw):
    ours, theirs = _datasets(data_dir, **kw)
    assert len(ours) == len(theirs)
    for idx in (0, 7, 33, 61, 90):
        a, b = ours[idx], theirs[idx]
        assert (a["scan_id"], a["z_id"]) == (b["scan_id"], b["z_id"])
        assert a["superpix_label"] == b["superpix_label"]
        for key in ("support_images", "query_images"):
            x = np.asarray(a[key][0] if key == "query_images"
                           else a[key][0][0])
            y = np.asarray(b[key][0] if key == "query_images"
                           else b[key][0][0])
            assert x.shape == y.shape
            assert np.abs(x - y).max() <= 1e-5 * max(np.ptp(y), 1e-12)
        assert np.array_equal(a["query_labels"][0], b["query_labels"][0])
        for m in ("fg_mask", "bg_mask"):
            assert np.array_equal(a["support_mask"][0][0][m],
                                  b["support_mask"][0][0][m])


def test_superpixel_refuses_clahe(data_dir):
    """CLAHE is no longer refused (its parity with JAX is
    ``tests/test_torch_clahe.py``): the MR fold clips at 4.0, as in JAX,
    and CLAHE changes the images, not the superpixel labels."""
    kw = dict(which_dataset="CHAOST2", base_dir=data_dir, idx_split=0,
              mode="train", image_size=HW, transforms=None)
    eq = superpixel.SuperpixelDataset(use_clahe=True, **kw)
    plain = superpixel.SuperpixelDataset(**kw)
    assert eq.clahe_clip == 4.0
    a, b = eq.actual_dataset[5], plain.actual_dataset[5]
    assert not np.allclose(a["img"], b["img"], atol=1e-2)
    np.testing.assert_array_equal(a["lb"], b["lb"])


# ------------------------------------------------------- train() vs JAX


def _cfgs(data_dir, log_dir):
    out = []
    for cls in (Config, JConfig):
        cfg = cls()
        cfg.dataset = "CHAOST2_Superpix"
        cfg.data_dirs = {"CHAOST2_Superpix": data_dir, "CHAOST2": data_dir}
        cfg.input_size = (HW, HW)
        cfg.modelname = "dinov2_t14"
        cfg.dtype = "float32"
        cfg.num_workers = 1
        cfg.print_interval = 1
        cfg.save_snapshot_every = 2
        cfg.exclude_cls_list = []
        cfg.seed = 3
        out.append(cfg)
    out[0].log_dir, out[1].log_dir = log_dir / "port", log_dir / "jax"
    out[0].log_dir, out[1].log_dir = str(out[0].log_dir), str(out[1].log_dir)
    return out


def _seeded_transforms(module):
    """Each ``train()`` call's augmentations from ``RandomState(7)``: JAX's
    trainer draws them from ``np.random`` and the elastic noise from an
    unseeded generator, so only a seeded generator compares runs."""
    return lambda aug: module.transform_with_label(
        aug, rng=np.random.RandomState(7))


@pytest.fixture(scope="module")
def jax_runs(data_dir, tmp_path_factory):
    """JAX's ``train()`` for 4 steps, then resumed to 5, with one worker,
    seeded augmentations and no TensorBoard; and its initial params as the
    port's state_dict."""
    class _JitInit(JFewShotSeg):
        """JAX's FewShotSeg with its init under jit (the same params as the
        eager init, in seconds instead of tens of them)."""

        def init(self, rng, *args):
            return jax.jit(super().init)(rng, *args)

    _, cfg = _cfgs(data_dir, tmp_path_factory.mktemp("train_logs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(jtrainer, "FewShotSeg", _JitInit)
        mp.setattr(jtrainer, "transform_with_label",
                   _seeded_transforms(jtransforms))
        first = jtrainer.train(cfg, max_steps=4)
        resumed = jtrainer.train(cfg, max_steps=5)
    hw = cfg.input_size[0]
    dummy = jnp.zeros((1, 3, hw, hw))
    m = jnp.zeros((1, hw, hw)).at[:, hw // 3: hw // 2,
                                  hw // 3: hw // 2].set(1.)
    model = _JitInit(image_size=hw, which_model=cfg.modelname,
                     proto_grid_size=cfg.proto_grid_size)
    params = model.init(jax.random.PRNGKey(cfg.seed), dummy, m, 1 - m,
                        dummy)["params"]
    sd = fewshot_state_dict(jax.tree.map(np.asarray, params))
    return first, resumed, sd


@pytest.fixture(scope="module")
def port_runs(data_dir, jax_runs, tmp_path_factory):
    cfg, _ = _cfgs(data_dir, tmp_path_factory.mktemp("port_logs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(trainer, "transform_with_label",
                   _seeded_transforms(transforms))
        first = trainer.train(cfg, max_steps=4, device="cpu",
                              state_dict=jax_runs[2])
        resumed = trainer.train(cfg, max_steps=5, device="cpu")
    return first, resumed, cfg


def _same_history(ours, theirs):
    assert [h["step"] for h in ours] == [h["step"] for h in theirs]
    for a, b in zip(ours, theirs):
        for k in ("loss", "ce", "align_loss"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (a, b)


def test_train_history_matches_jax(jax_runs, port_runs):
    _same_history(port_runs[0]["history"], jax_runs[0]["history"])
    assert port_runs[0]["step"] == 4 == int(jax_runs[0]["state"].step)
    assert len(port_runs[0]["step_ms"]) == len(port_runs[0]["wait_ms"]) == 4


def test_train_resumes_from_its_snapshots(jax_runs, port_runs):
    import json
    import os

    first, resumed, cfg = port_runs
    assert resumed["step"] == 5
    _same_history(resumed["history"], jax_runs[1]["history"])
    snaps = sorted(os.listdir(os.path.join(cfg.log_dir, "snapshots")))
    assert snaps == ["step_2.pt", "step_4.pt", "step_5.pt"]
    with open(os.path.join(cfg.log_dir, "train_metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == [1, 2, 3, 4, 5]
    assert os.path.exists(os.path.join(cfg.log_dir, "config.json"))


def test_non_finite_loss_skips_the_update(data_dir, tmp_path, monkeypatch):
    """A NaN episode (step 2) is skipped: the params keep the bits they
    had, the step count does not move, and the history leaves it out."""
    cfg, _ = _cfgs(data_dir, tmp_path)
    cfg.log_dir = ""
    real = trainer.train_step
    seen = []

    def step(model, opt, batch, *args, **kwargs):
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        if len(seen) == 2:
            batch.qry = batch.qry * float("nan")
        return real(model, opt, batch, *args, **kwargs)

    monkeypatch.setattr(trainer, "train_step", step)
    out = trainer.train(cfg, max_steps=4, device="cpu")
    assert out["skipped"] == 1 and out["step"] == 3
    assert [h["step"] for h in out["history"]] == [1, 3, 4]
    assert all(torch.equal(seen[1][k], v) for k, v in seen[2].items())
    assert not all(torch.equal(seen[0][k], v) for k, v in seen[1].items())
