"""The port's evaluation data layer and driver against the JAX package on
the CPU: NIfTI files both ways, ``MedicalVolumeDataset`` (JAX's cv2 path
with its native feeder off, and its native path), the metrics, the
detection table and ``run_eval`` on a synthetic CHAOS-T2 fold
(``tests/synthetic_data.py``) with the same tiny weights on both sides
(dinov2_t14 at 64 px + SAM vit_t at a 256 frame, f32)."""

import gzip
import json

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import cv2

    import protosam_tpu.native
    from protosam_tpu.data import medical as jmedical
    from protosam_tpu.data import nifti as jnifti
    from protosam_tpu.eval import protosam_eval as jeval
    from protosam_tpu.utils import detection as jdetection
    from protosam_tpu.utils import metrics as jmetrics
    from protosam_tpu.utils.config import Config as JConfig
    from tests.synthetic_data import HW, make_dataset
except ImportError:
    pass

from torch_parity import (dice, jax_coarse_params, jax_sam_params,
                                record_calls, seeded_state_dict)

import protosam_tpu_torch.native
from protosam_tpu_torch.data import medical, nifti, png
from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.utils import detection, metrics
from protosam_tpu_torch.utils.config import Config

torch.set_num_threads(2)

SAM_FRAME = 256  # grid 16: at 128 (grid 8 < window 14) JAX stores 15-row
# rel-pos tables where the reference layout has 27, so no weights are shared


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("chaos")))


# ------------------------------------------------------------------ NIfTI


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nifti_files_cross_read(tmp_path, writer, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(4, 8, 9)) * 20).astype(dtype)
    img = (jnifti if writer == "jax" else nifti).NiftiImage(
        arr, spacing=(1.0, 2.0, 3.0), origin=(5.0, 6.0, 7.0))
    path = tmp_path / "v.nii.gz"
    (jnifti if writer == "jax" else nifti).write_nii(img, path)
    reader = nifti if writer == "jax" else jnifti
    back = reader.read_nii(path, peel_info=False)
    assert back.array.dtype == arr.dtype
    np.testing.assert_array_equal(back.array, arr)
    np.testing.assert_allclose(back.spacing, img.spacing, atol=1e-5)
    np.testing.assert_allclose(back.origin, img.origin, atol=1e-5)
    np.testing.assert_allclose(back.direction, img.direction, atol=1e-6)
    # both writers give the same bytes (gzip headers aside)
    other = jnifti if writer == "port" else nifti
    other.write_nii(img, tmp_path / "w.nii.gz")
    assert gzip.decompress(path.read_bytes()) == gzip.decompress(
        (tmp_path / "w.nii.gz").read_bytes())


# -------------------------------------------------------- the data layer


def _native(monkeypatch, on: bool):
    """Both packages' switch of the native feeder: off takes each one's
    numpy path, on each one's C++ feeder (the port's own since it has
    one)."""
    for mod in (protosam_tpu.native, protosam_tpu_torch.native):
        monkeypatch.setattr(mod, "native_available", lambda: on)


def _datasets(data_dir, size, native, monkeypatch):
    _native(monkeypatch, native)
    kw = dict(dataset_name="CHAOST2", base_dir=data_dir, idx_split=0,
              act_labels=[1, 2, 3, 4], npart=3, image_size=size)
    return jmedical.med_fewshot_val(**kw), medical.med_fewshot_val(**kw)


@pytest.mark.parametrize("size", [48, 96])
@pytest.mark.parametrize("native", [False, True], ids=["cv2", "native"])
def test_medical_dataset_matches_jax(data_dir, monkeypatch, size, native):
    """Slice order, scan ids, part_assign and the support set as JAX's;
    labels and images bit-equal, to JAX's cv2 path (both feeders off) and
    to JAX's native feeder (both on)."""
    calls = protosam_tpu_torch.native.feeder.calls
    (jval, jparent), (val, parent) = _datasets(data_dir, size, native,
                                               monkeypatch)
    # the port took the path asked for
    assert (protosam_tpu_torch.native.feeder.calls > calls) == native
    assert list(parent.pid_curr_load) == list(jparent.pid_curr_load)
    assert parent.scan_z_idx == jparent.scan_z_idx
    assert parent.idx_by_class == jparent.idx_by_class
    assert [(r.scan_id, r.z_id, r.nframe) for r in parent.actual_dataset] \
        == [(r.scan_id, r.z_id, r.nframe) for r in jparent.actual_dataset]
    tol = dict(rtol=0, atol=0)
    for cls in (2, 4):
        val.set_curr_cls(cls)
        jval.set_curr_cls(cls)
        for idx in range(len(val)):
            s, js = val[idx], jval[idx]
            for key in ("part_assign", "case", "z_min", "z_max", "z_id",
                        "is_start", "is_end", "nframe"):
                assert s[key] == js[key], key
            assert s["image"].shape == (3, size, size)
            np.testing.assert_array_equal(s["label"], js["label"])
            np.testing.assert_allclose(s["image"], js["image"], **tol)
        task = {"support_idx": [-1], "task": {"npart": 3}}
        sup, jsup = val.get_support_set(task), jval.get_support_set(task)
        assert sup["support_scan_id"] == jsup["support_scan_id"]
        for a, b in zip(sup["support_labels"], jsup["support_labels"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sup["support_images"], jsup["support_images"]):
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("use_3_slices", [False, True],
                         ids=["tiled", "3-slices"])
def test_dataset_scan_helpers_match_jax(data_dir, monkeypatch, use_3_slices):
    """The whole-scan support, the per-class supports and the full-scan
    item as JAX's (cv2 path), with 3-slice inputs too."""
    _native(monkeypatch, False)
    kw = dict(which_dataset="CHAOST2", base_dir=data_dir, idx_split=1,
              image_size=80, use_3_slices=use_3_slices)
    ours, theirs = medical.MedicalVolumeDataset(**kw), \
        jmedical.MedicalVolumeDataset(**kw)
    tol = dict(rtol=0, atol=0)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, **tol)
        else:
            assert a == b

    same(ours.get_support_scan(2, [2], [-1]),
         theirs.get_support_scan(2, [2], [-1]))
    same(ours.get_support_multiple_classes([2, 3], [-1], npart=3),
         theirs.get_support_multiple_classes([2, 3], [-1], npart=3))
    for i in (0, 3):
        same(ours.get_scan(i), theirs.get_scan(i))
    for i in (0, 7, len(ours) - 1):
        same(ours[i], theirs[i])


def test_medical_dataset_refuses_clahe(data_dir):
    """CLAHE is no longer refused (its parity with JAX is
    ``tests/test_torch_clahe.py``): as in JAX it turns the native feeder
    off, and it changes the images."""
    calls = protosam_tpu_torch.native.feeder.calls
    eq = medical.MedicalVolumeDataset("CHAOST2", data_dir, 0, 64,
                                      use_clahe=True)
    assert protosam_tpu_torch.native.feeder.calls == calls
    plain = medical.MedicalVolumeDataset("CHAOST2", data_dir, 0, 64)
    assert protosam_tpu_torch.native.feeder.calls > calls
    assert not np.allclose(eq[3]["image"], plain[3]["image"], atol=1e-2)
    np.testing.assert_array_equal(eq[3]["label"], plain[3]["label"])


# ---------------------------------------------------- metrics, detection


def _masks(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        m = np.zeros((24, 20), np.float32)
        y, x = rng.integers(0, 20, 2)
        m[y:y + rng.integers(1, 8), x:x + rng.integers(1, 8)] = 1
        out.append(m)
    out += [np.zeros((24, 20), np.float32), np.ones((24, 20), np.float32)]
    single = np.zeros((24, 20), np.float32)
    single[23, 19] = 1
    return out + [single]


def test_dice_iou_precision_recall_matches_jax():
    masks = _masks(0)
    for pred in masks:
        for gt in masks:  # the empty ground truth and prediction included
            assert metrics.dice_iou_precision_recall(pred, gt) == \
                jmetrics.dice_iou_precision_recall(pred, gt)


def test_metric_accumulator_matches_jax():
    masks = _masks(1)
    ours, theirs = metrics.Metric(4, n_scans=3), jmetrics.Metric(4, n_scans=3)
    for i, (p, g) in enumerate(zip(masks, masks[::-1])):
        for m in (ours, theirs):
            m.record(p, g, labels=[2], n_scan=i % 3)
    for name, kw in (("get_mDice", {"labels": [2]}),
                     ("get_mIoU", {"labels": [2]}),
                     ("get_mPrecRecall", {"labels": [2]}),
                     ("get_mDice", {"labels": [2], "n_scan": 1})):
        a, b = getattr(ours, name)(**kw), getattr(theirs, name)(**kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x, float),
                                          np.asarray(y, float))


def test_bounding_box_has_cv2_semantics():
    for m in _masks(2):
        assert detection.get_bounding_box(m) == cv2.boundingRect(
            m.astype(np.uint8))
        assert detection.get_bounding_box(m) == jdetection.get_bounding_box(m)
    assert detection.get_bounding_box(np.zeros((5, 5))) == (0, 0, 0, 0)


@pytest.mark.parametrize("n", [0, 1, 9])
def test_eval_detection_matches_jax(n):
    masks = _masks(3)
    preds = [{"pred_bbox": detection.get_bounding_box(masks[i % 9]),
              "gt_bbox": detection.get_bounding_box(masks[(i * 4) % 9]),
              "score": 0.5} for i in range(n)]
    want = jdetection.eval_detection(preds).to_dict(orient="records")
    got = detection.eval_detection(preds)
    assert json.dumps(got) == json.dumps(want)


# ------------------------------------------------------------- run_eval


def _cfg(cls, data_dir, log_dir=""):
    cfg = cls()
    cfg.dataset = "CHAOST2"
    cfg.data_dirs = {"CHAOST2": data_dir}
    cfg.input_size = (HW, HW)
    cfg.modelname = "dinov2_t14"
    cfg.protosam_sam_ver = "vit_t"
    cfg.curr_cls = "rk"
    cfg.do_cca = True
    cfg.support_idx = [-1]
    cfg.dtype = "float32"
    cfg.slice_batch = 2
    cfg.max_ccs = 4
    cfg.log_dir = log_dir
    return cfg


@pytest.fixture(scope="module")
def weights():
    coarse = FewShotSeg(image_size=HW, which_model="dinov2_t14")
    sam = build_sam("vit_t", image_size=SAM_FRAME)
    return seeded_state_dict(coarse, 0), seeded_state_dict(sam, 1)


@pytest.fixture(scope="module")
def jax_run(data_dir, weights):
    """JAX's run_eval in volume mode, once, with its masks recorded."""
    csd, ssd = weights
    mp = pytest.MonkeyPatch()
    orig = jeval.build_sam
    mp.setattr(jeval, "build_sam",
               lambda t, dtype, **kw: orig(t, dtype, SAM_FRAME, **kw))
    monkey_native = pytest.MonkeyPatch()
    monkey_native.setattr(protosam_tpu.native, "native_available",
                          lambda: False)
    try:
        cfg = _cfg(JConfig, data_dir)
        pipe = jeval.build_models(cfg, coarse_params=jax_coarse_params(csd),
                                  sam_params=jax_sam_params(ssd))
        masks = []
        record_calls(pipe, "forward_volume", masks)
        result = jeval.run_eval(cfg, pipe=pipe, mode="volume")
    finally:
        mp.undo()
        monkey_native.undo()
    return result, np.concatenate(masks)


@pytest.fixture(scope="module")
def port_pipe(weights):
    csd, ssd = weights
    mp = pytest.MonkeyPatch()
    mp.setattr(protosam_eval, "SAM_IMAGE_SIZE", SAM_FRAME)
    try:
        return protosam_eval.build_models(_cfg(Config, ""), device="cpu",
                                          coarse_state=csd, sam_state=ssd)
    finally:
        mp.undo()


def _port_run(data_dir, pipe, mode, log_dir=""):
    """The port's run_eval, with its native feeder off as JAX's is in
    ``jax_run``."""
    masks = []
    name = "forward_volume" if mode == "volume" else "forward"
    record_calls(pipe, name, masks)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(protosam_tpu_torch.native, "native_available",
                       lambda: False)
            result = protosam_eval.run_eval(_cfg(Config, data_dir, log_dir),
                                            pipe=pipe, mode=mode)
    finally:
        delattr(pipe, name)
    masks = np.concatenate(masks) if mode == "volume" else np.stack(masks)
    return result, masks


def test_run_eval_matches_jax(data_dir, jax_run, port_pipe, tmp_path):
    """Same keys, slices and detection table layout; per-case meanDice
    within 1e-4 and every slice's mask at Dice >= 0.99 against JAX's; and
    ``log_dir`` holds the config, the result and the sources."""
    want, jmasks = jax_run
    got, masks = _port_run(data_dir, port_pipe, "volume",
                           str(tmp_path / "run"))
    assert set(got) == set(want)
    assert got["n_slices"] == want["n_slices"] > 0
    assert set(got["cases"]) == set(want["cases"])
    for case, row in want["cases"].items():
        assert abs(got["cases"][case]["meanDice"] - row["meanDice"]) <= 1e-4
    for key in ("mar_val_batches_meanDice", "mar_val_batches_meanPrec",
                "mar_val_al_batches_meanRec", "mar_val_al_batches_meanIOU"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    assert [set(r) for r in got["detection_f1"]] == \
        [set(r) for r in want["detection_f1"]]
    assert masks.shape == jmasks.shape
    assert min(dice(a, b) for a, b in zip(masks, jmasks)) >= 0.99
    # the weights make real masks: neither all empty nor all foreground
    assert 0.0 < float(masks.mean()) < 1.0
    assert 0.0 < got["mar_val_batches_meanDice"] < 1.0
    run = tmp_path / "run"
    assert json.loads((run / "config.json").read_text())["modelname"] == \
        "dinov2_t14"
    assert json.loads((run / "protosam_eval_result.json").read_text()) == \
        json.loads(json.dumps(got))
    assert (run / "_sources").is_dir()


def test_run_eval_modes_agree(data_dir, port_pipe):
    """per_slice gives volume's masks and metrics."""
    vol, vmasks = _port_run(data_dir, port_pipe, "volume")
    slc, smasks = _port_run(data_dir, port_pipe, "per_slice")
    np.testing.assert_array_equal(vmasks, smasks)
    for r in (vol, slc):
        r.pop("slices_per_sec")
    assert vol == slc


@pytest.mark.parametrize("overrides", [
    dict(base_model="SAM", dataset="polyps"), dict(dataset="polyps")],
    ids=["sam-oracle", "polyps"])
def test_run_eval_refuses_what_is_not_ported(port_pipe, tmp_path, overrides):
    """``run_eval(dataset="polyps")`` takes the polyp branch, through the
    pipeline and with ``base_model="SAM"`` too (JAX asks for base_model
    first, and its oracle then fails on a polyp fold): the result is
    ``run_eval_polyp``'s, with JAX's keys.  The branch itself is held to
    JAX's in ``tests/test_torch_polyp.py``."""
    rng = np.random.default_rng(0)
    kvasir = tmp_path / "Kvasir"
    for sub in ("images", "masks"):
        (kvasir / sub).mkdir(parents=True)
    for i in range(3):
        png.write_png(str(kvasir / "images" / f"k{i}.png"),
                      rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
        mask = np.zeros((48, 64), np.uint8)
        mask[10 + 4 * i:30, 20:40 + 5 * i] = 255
        png.write_png(str(kvasir / "masks" / f"k{i}.png"), mask)
    (kvasir / "split.txt").write_text("train:\nk0\nval:\ntest:\nk1\nk2\n")
    cfg = _cfg(Config, "")
    cfg.data_dirs = {"polyps": str(tmp_path)}
    cfg.input_size = (SAM_FRAME, SAM_FRAME)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    calls = []
    orig = protosam_eval.run_eval_polyp
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(protosam_eval, "run_eval_polyp",
                   lambda *a, **kw: calls.append(1) or orig(*a, **kw))
        got = protosam_eval.run_eval(cfg, pipe=port_pipe)
    assert calls == [1]
    want = orig(cfg, port_pipe)
    assert set(got) == {"mar_val_batches_meanDice", "mar_val_batches_meanPrec",
                        "mar_val_al_batches_meanRec",
                        "mar_val_al_batches_meanIOU", "cases", "n_slices",
                        "slices_per_sec"}
    for r in (got, want):
        r.pop("slices_per_sec")
    assert got == want and got["n_slices"] == 2
    assert set(got["cases"]) == {"Kvasir"}


def test_resolve_test_class_matches_jax():
    for dataset, organs in (("CHAOST2_Superpix_672", ("liver", "rk", "lk",
                                                       "spleen")),
                            ("SABS_Superpix", ("spleen", "rk", "lk",
                                               "liver"))):
        for organ in organs:
            ours, theirs = Config(dataset=dataset, curr_cls=organ), \
                JConfig(dataset=dataset, curr_cls=organ)
            assert protosam_eval.resolve_test_class(ours) == \
                jeval.resolve_test_class(theirs)
