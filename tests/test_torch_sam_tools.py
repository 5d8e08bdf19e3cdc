"""The port's SAM tools against the JAX package on the CPU (f32): the RLE
codecs, the automatic mask generator's helpers and ``generate()``, the
predictor, ``SamWrapper`` and ``run_eval(base_model="SAM")``.

Two tiny SAMs (vit_t at 256 px, the same weights on both sides through
``convert_sam``): the recorded masks' recipe (``utils/synthetic.
seeded_tiny_sam``) for the predictor, and ``structured_tiny_sam`` for the
generator, whose one-point masks vary in area and stability (the recorded
recipe's are empty or full, stability 0).  Inputs are seeded with numpy."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from protosam_tpu.eval import protosam_eval as jeval
    from protosam_tpu.models.sam import amg as jamg
    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.models.sam import rle as jrle
    from protosam_tpu.models.sam.predictor import SamPredictor as JPredictor
    from protosam_tpu.models.sam.sam import \
        postprocess_masks as jpostprocess
    from protosam_tpu.models.samwrapper import SamWrapper as JSamWrapper
    from protosam_tpu.models.samwrapper import get_iou as jget_iou
    from protosam_tpu.utils.config import Config as JConfig
    from tests.synthetic_data import HW, make_dataset
except ImportError:
    pass

from torch_parity import dice, jax_sam_params

from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.models.sam import amg, rle
from protosam_tpu_torch.models.sam.predictor import SamPredictor
from protosam_tpu_torch.models.samwrapper import SamWrapper, get_iou
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.synthetic import (seeded_tiny_sam,
                                                structured_tiny_sam,
                                                synthetic_agreement_case)

torch.set_num_threads(2)

SCORE_TOL = 1e-4   # predicted_iou, stability_score, iou_predictions, low-res
DICE_BAR = 0.99


def _image(i=2, h=200, w=240):
    """A uint8 (h, w, 3) crop of recorded slice ``i``'s query: blobs on
    hash noise."""
    q = synthetic_agreement_case(i)[0][0].transpose(1, 2, 0)[:h, :w]
    return ((q - q.min()) / (q.max() - q.min()) * 255).astype(np.uint8)


# ------------------------------------------------------------------ RLE


@pytest.mark.parametrize("shape", [(7, 5), (32, 32), (63, 17)])
def test_rle_codecs_match_jax(shape):
    rng = np.random.default_rng(0)
    for density in (0.0, 0.2, 0.5, 1.0):
        mask = rng.random(shape) < density
        got, want = rle.mask_to_rle(mask), jrle.mask_to_rle(mask)
        assert got == want  # bit-equal counts
        assert rle.coco_encode_rle(got) == jrle.coco_encode_rle(want)
        enc = rle.coco_encode_rle(got)
        assert rle.coco_decode_rle(enc) == jrle.coco_decode_rle(enc)
        np.testing.assert_array_equal(rle.rle_to_mask(got), mask)
        assert rle.area_from_rle(got) == jrle.area_from_rle(want)


# ------------------------------------------------------------- helpers


def test_grids_and_crop_boxes_match_jax():
    for n in (4, 8, 32):
        np.testing.assert_array_equal(amg.build_point_grid(n),
                                      jamg.build_point_grid(n))
    for got, want in zip(amg.build_all_layer_point_grids(16, 2, 2),
                         jamg.build_all_layer_point_grids(16, 2, 2)):
        np.testing.assert_array_equal(got, want)
    for size, layers in (((600, 800), 2), ((200, 240), 1), ((96, 96), 0)):
        assert amg.generate_crop_boxes(size, layers, 512 / 1500) == \
            jamg.generate_crop_boxes(size, layers, 512 / 1500)


def test_box_helpers_and_stability_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((6, 40, 48)) * 3).astype(np.float32)
    logits[2] = -5.0  # an empty mask
    st = amg.stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy()
    np.testing.assert_array_equal(st, np.asarray(jamg.stability_score(
        jnp.asarray(logits), 0.0, 1.0)))  # exact: f32 quotients
    m = logits > 0.5
    np.testing.assert_array_equal(
        amg.mask_to_box(torch.from_numpy(m)).numpy(),
        np.asarray(jamg.mask_to_box(jnp.asarray(m))))
    boxes = np.sort(rng.random((20, 2, 2)) * 100, axis=1).reshape(
        20, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    np.testing.assert_array_equal(
        amg.box_iou(torch.from_numpy(boxes)).numpy(),
        np.asarray(jamg.box_iou(jnp.asarray(boxes))))  # exact: same ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_matches_jax_with_ties(seed):
    """Seeded boxes in clusters, scores with ties (equal scores go to the
    lowest index), some invalid: equal keep masks."""
    rng = np.random.default_rng(seed)
    n = 60
    centre = rng.integers(0, 5, n)[:, None] * 30 + rng.random((n, 2)) * 6
    size = 12 + rng.random((n, 2)) * 4
    boxes = np.concatenate([centre, centre + size], 1).astype(np.float32)
    boxes[5] = boxes[4]  # identical boxes
    scores = rng.integers(0, 6, n).astype(np.float32) / 5  # many ties
    valid = rng.random(n) > 0.1
    for thresh in (0.3, 0.5, 0.7):
        got = amg.nms_keep(boxes, scores, valid, thresh)
        want = np.asarray(jamg.nms_keep(jnp.asarray(boxes),
                                        jnp.asarray(scores),
                                        jnp.asarray(valid), thresh))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(mode):
    rng = np.random.default_rng(3)
    for trial in range(3):
        low = torch.from_numpy(rng.random((1, 1, 12, 12)))
        m = (torch.nn.functional.interpolate(
            low, (96, 96), mode="bilinear", align_corners=False)[0, 0]
             > 0.55).numpy()
        for thresh in (10, 60, 5000):
            got, g_changed = amg.remove_small_regions(m.copy(), thresh,
                                                      mode, device="cpu")
            want, w_changed = jamg.remove_small_regions(m.copy(), thresh,
                                                        mode)
            assert g_changed == w_changed, (trial, thresh)
            np.testing.assert_array_equal(got, np.asarray(want, bool))


# --------------------------------------------------------- the generator


@pytest.fixture(scope="module")
def structured():
    sam = structured_tiny_sam()
    return sam, jbuild_sam("vit_t", image_size=256), \
        jax_sam_params(sam.state_dict())


AMG_KW = dict(points_per_side=8, points_per_batch=32, pred_iou_thresh=0.0,
              stability_score_thresh=0.5)


def _records_equal(got, want, output_mode):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("area", "predicted_iou", "stability_score", "bbox",
                  "point_coords", "crop_box"):
            assert g[k] == w[k], k
        if output_mode == "binary_mask":
            np.testing.assert_array_equal(g["segmentation"],
                                          np.asarray(w["segmentation"]))
        else:
            assert g["segmentation"] == w["segmentation"]


GENERATE_CASES = [(0, 0, "binary_mask"), (0, 30, "uncompressed_rle"),
                  (1, 30, "coco_rle")]


@pytest.fixture(scope="module")
def jax_generate(structured):
    """JAX's ``generate()`` on ``_image()`` for each case of
    ``GENERATE_CASES``, once: its records, every batch decode's outputs
    and every candidate's (iou, stability).  The cases share one jitted
    batch decode (same thresholds)."""
    _, jsam, params = structured
    runs, shared = {}, None
    for case in GENERATE_CASES:
        crop_n_layers, min_area, output_mode = case
        jgen = jamg.SamAutomaticMaskGenerator(
            jsam, params, **AMG_KW, crop_n_layers=crop_n_layers,
            min_mask_region_area=min_area, output_mode=output_mode)
        shared = shared or jgen._decode_batch
        decoded = []

        def recording(p, emb, coords, decoded=decoded):
            out = shared(p, emb, coords)
            decoded.append([np.asarray(t) for t in out])
            return out

        jgen._decode_batch = recording
        records = jgen.generate(image=_image(), image_size=256)
        runs[case] = (records, decoded)
    return runs


def _generator(sam, case):
    crop_n_layers, min_area, output_mode = case
    return amg.SamAutomaticMaskGenerator(
        sam, **AMG_KW, crop_n_layers=crop_n_layers,
        min_mask_region_area=min_area, output_mode=output_mode)


@pytest.mark.parametrize("case", [GENERATE_CASES[1], GENERATE_CASES[2]],
                         ids=["small-regions", "crops"])
def test_generate_post_decode_matches_jax_bit_for_bit(structured,
                                                      jax_generate, case):
    """Given JAX's own decoder outputs, the port's filtering, per-crop and
    cross-crop NMS, upscale, small-region pass and records are JAX's, bit
    for bit."""
    want, decoded = jax_generate[case]
    gen = _generator(structured[0], case)
    replay = iter(decoded)
    gen._decode_batch = lambda emb, coords: tuple(
        torch.from_numpy(t.copy()).to(dt) for t, dt in zip(
            next(replay), (torch.float32, torch.float32, torch.float32,
                           torch.int64, torch.int64)))
    # the crops' embeddings are JAX's business here: only their frames
    gen._encode = lambda image: (
        None, amg.longest_side_size(*image.shape[:2], 256))
    got = gen.generate(image=_image(), image_size=256)
    assert next(replay, None) is None
    _records_equal(got, want, case[2])


def _threshold_explained(jl, pl, stab_thresholds, tol=SCORE_TOL):
    """Whether every low-res pixel that one side puts past a stability
    threshold (``mask_threshold`` ± offset) and the other not lies within
    ``tol`` of that threshold in JAX's logits."""
    for t in stab_thresholds:
        flip = (jl > t) != (pl > t)
        if (np.abs(jl[flip] - t) > tol).any():
            return False
    return True


@pytest.mark.parametrize("case", GENERATE_CASES,
                         ids=["plain", "small-regions", "crops"])
def test_generate_matches_jax(structured, jax_generate, case):
    """End to end on the same weights.  Every candidate's predicted IoU is
    within SCORE_TOL of JAX's, and so is its stability score unless a
    low-res pixel sits within SCORE_TOL of ``mask_threshold`` ± offset
    (one pixel moves a 64² count ratio by ~2.4e-4); a keep decision may
    differ only for such a candidate or one within SCORE_TOL of a keep
    threshold.  Those candidates are counted and printed; records match
    one for one at Dice >= 0.99, predicted_iou and stability_score within
    SCORE_TOL but for the counted candidates."""
    want, decoded = jax_generate[case]
    gen = _generator(structured[0], case)
    port = []
    decode = gen._decode_batch

    def recording(emb, coords):
        out = decode(emb, coords)
        port.append([t.numpy() for t in out])
        return out

    gen._decode_batch = recording
    got = gen.generate(image=_image(), image_size=256)

    assert len(port) == len(decoded)
    off = gen.stability_score_offset
    stab_thr = (gen.mask_threshold + off, gen.mask_threshold - off)
    keep_thr = np.array([AMG_KW["pred_iou_thresh"],
                         AMG_KW["stability_score_thresh"]], np.float32)
    counted, n = [], 0  # JAX's predicted IoU of each counted candidate
    for j, p in zip(decoded, port):
        assert np.abs(j[1] - p[1]).max() <= SCORE_TOL  # predicted IoU
        for c in range(len(j[1])):
            n += 1
            js, ps = np.array([j[1][c], j[2][c]]), np.array([p[1][c],
                                                              p[2][c]])
            stab_moved = abs(js[1] - ps[1]) > SCORE_TOL
            if stab_moved:
                assert _threshold_explained(j[0][c], p[0][c], stab_thr), c
            flip = ((js > keep_thr) != (ps > keep_thr)).any()
            near = (np.abs(js - keep_thr) <= SCORE_TOL).any()
            assert not flip or near or stab_moved, c
            if stab_moved or flip:
                counted.append(float(j[1][c]))
    print(f"{n} candidates; {len(counted)} with a pixel or a score at a "
          f"threshold (stability moved or keep decision differs)")

    def seg(r):
        s = r["segmentation"]
        if case[2] == "coco_rle":
            s = rle.coco_decode_rle(s)
        return s if case[2] == "binary_mask" else rle.rle_to_mask(s)

    def is_counted(r):
        return any(abs(r["predicted_iou"] - v) <= SCORE_TOL
                   for v in counted)

    assert len(want) > 0
    assert abs(len(got) - len(want)) <= len(counted)
    for w in want:
        # the port's record of the same candidate: same point and crop,
        # the closest predicted IoU
        same = [g for g in got if g["point_coords"] == w["point_coords"]
                and g["crop_box"] == w["crop_box"]
                and abs(g["predicted_iou"] - w["predicted_iou"])
                <= SCORE_TOL]
        if not same:
            assert is_counted(w)
            continue
        g = min(same, key=lambda g: abs(g["predicted_iou"]
                                        - w["predicted_iou"]))
        assert abs(g["stability_score"] - w["stability_score"]) \
            <= SCORE_TOL or is_counted(w)
        assert dice(seg(g), seg(w)) >= DICE_BAR


# --------------------------------------------------------- the predictor


@pytest.fixture(scope="module")
def predictors():
    sam = seeded_tiny_sam()
    jsam = jbuild_sam("vit_t", image_size=256)
    img = _image(1, 180, 230)
    pred, jpred = SamPredictor(sam), JPredictor(
        jsam, jax_sam_params(sam.state_dict()))
    pred.set_image(img)
    jpred.set_image(img)
    return pred, jpred


@pytest.mark.parametrize("prompt", ["point", "points", "box", "box+point"])
def test_predictor_matches_jax(predictors, prompt):
    pred, jpred = predictors
    kw = {"point": dict(point_coords=[[90.0, 80.0]], point_labels=[1]),
          "points": dict(point_coords=[[90.0, 80.0], [150.0, 40.0]],
                         point_labels=[1, 0]),
          "box": dict(box=[40.0, 30.0, 160.0, 150.0]),
          "box+point": dict(point_coords=[[90.0, 80.0]], point_labels=[1],
                            box=[40.0, 30.0, 160.0, 150.0])}[prompt]
    for multimask in (True, False):
        got = pred.predict(multimask_output=multimask, **kw)
        want = jpred.predict(multimask_output=multimask, **kw)
        assert got[0].shape == want[0].shape == (got[0].shape[0], 180, 230)
        for g, w in zip(got[0], want[0]):
            assert dice(g, w) >= DICE_BAR
        np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL)
        np.testing.assert_allclose(got[2], want[2], atol=SCORE_TOL)
    assert 0 < got[0].mean() < 1  # real masks


def test_predictor_mask_input_matches_jax_decode(predictors):
    """``mask_input`` from the first call's low-res output: JAX's predictor
    reshapes it to the 1024 frame's (1, 256, 256, 1), so the JAX side is
    its decode and ``postprocess_masks`` on the tiny SAM's (1, 64, 64, 1)."""
    pred, jpred = predictors
    _, _, low = pred.predict(point_coords=[[90.0, 80.0]], point_labels=[1])
    got = pred.predict(point_coords=[[90.0, 80.0]], point_labels=[1],
                       mask_input=low[:1])
    scale = np.asarray([pred.input_size[1] / 230, pred.input_size[0] / 180])
    coords = jnp.asarray((np.asarray([[90.0, 80.0]], np.float32)
                          * scale)[None])
    low_res, iou = jpred._decode(
        jpred.params, jpred.features, coords, jnp.ones((1, 1), jnp.int32),
        None, jnp.asarray(low[:1, :, :, None]), True, True)
    masks = np.asarray(jpostprocess(low_res, jpred.input_size,
                                    jpred.original_size, 256))[0] > 0
    for g, w in zip(got[0], masks):
        assert dice(g, w) >= DICE_BAR
    np.testing.assert_allclose(got[1], np.asarray(iou[0]), atol=SCORE_TOL)
    np.testing.assert_allclose(got[2], np.asarray(low_res[0]),
                               atol=SCORE_TOL)


# ------------------------------------------------ SamWrapper, the oracle


def test_samwrapper_matches_jax(structured):
    sam, jsam, params = structured
    img = _image(3, 96, 120)
    gt = np.zeros((96, 120), np.uint8)
    gt[30:70, 40:90] = 1
    got = SamWrapper(sam, **AMG_KW)(img, gt)
    want = JSamWrapper(jsam, params, **AMG_KW)(img, gt)
    assert got.dtype == np.float32 and got.shape == (96, 120)
    assert 0 < got.mean() < 1
    assert dice(got, want) >= DICE_BAR
    assert get_iou(got > 0, gt) == pytest.approx(
        jget_iou(want > 0, gt), abs=1e-2)


@pytest.fixture(scope="module")
def oracle_fold(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("chaos_oracle")))


def _oracle_cfg(cls, data_dir):
    cfg = cls()
    cfg.dataset = "CHAOST2"
    cfg.data_dirs = {"CHAOST2": data_dir}
    cfg.input_size = (HW, HW)
    cfg.base_model = "SAM"
    cfg.protosam_sam_ver = "vit_t"
    cfg.curr_cls = "rk"
    cfg.skip_no_organ_slices = True
    cfg.dtype = "float32"
    return cfg


ORACLE_KW = dict(AMG_KW, points_per_side=4)  # 48 candidates a slice


@pytest.fixture(scope="module")
def jax_oracle(structured, oracle_fold):
    _, jsam, params = structured
    return jeval.run_eval_sam_oracle(
        _oracle_cfg(JConfig, oracle_fold),
        wrapper=JSamWrapper(jsam, params, **ORACLE_KW))


def test_run_eval_sam_oracle_matches_jax(structured, oracle_fold,
                                         jax_oracle):
    """``run_eval(base_model="SAM")`` against JAX's ``run_eval_sam_oracle``
    with the same wrapped SAM: metrics within 1e-3."""
    sam = structured[0]
    want = jax_oracle
    got = protosam_eval.run_eval(_oracle_cfg(Config, oracle_fold),
                                 pipe=SamWrapper(sam, **ORACLE_KW))
    assert set(want) <= set(got)
    assert got["n_slices"] == want["n_slices"] > 0
    print(f"{got['n_slices']} slices, meanDice "
          f"{got['mar_val_batches_meanDice']:.6f} (JAX "
          f"{want['mar_val_batches_meanDice']:.6f})")
    assert abs(got["mar_val_batches_meanDice"]
               - want["mar_val_batches_meanDice"]) <= 1e-3
    assert set(got["cases"]) == set(want["cases"])
    for case, row in want["cases"].items():
        assert abs(got["cases"][case]["meanDice"] - row["meanDice"]) <= 1e-3
    assert 0 < got["mar_val_batches_meanDice"] < 1


def test_build_sam_oracle_loads_a_pth(tmp_path, oracle_fold):
    """The oracle's default SAM: seeded from ``cfg.seed``, or the weights
    of ``reload_model_path`` (a SAM ``.pth``), loaded strictly."""
    cfg = _oracle_cfg(Config, oracle_fold)
    seeded = protosam_eval.build_sam_oracle(cfg, device="cpu")
    assert seeded.sam.image_size == protosam_eval.SAM_IMAGE_SIZE
    sd = structured_tiny_sam().state_dict()
    torch.save(sd, tmp_path / "sam.pth")
    cfg.reload_model_path = str(tmp_path / "sam.pth")
    protosam_eval.SAM_IMAGE_SIZE, size = 256, protosam_eval.SAM_IMAGE_SIZE
    try:
        loaded = protosam_eval.build_sam_oracle(cfg, device="cpu")
    finally:
        protosam_eval.SAM_IMAGE_SIZE = size
    for k, v in loaded.sam.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
