"""The port's polyp path against the JAX package on the CPU: the datasets
(``data/polyp.py``) on a fold written with cv2 as ``tests/test_polyp.py``
writes one, the paired transforms (``data/polyp_transforms.py``) under
seeded generators, the cv2 arithmetic they stand on (resizes, the nearest
warp, RGB <-> HSV) against cv2 5.0, and ``run_eval_polyp`` with the same
tiny weights on both sides (dinov2_t14 + SAM vit_t at a 256 frame, f32)."""

import os

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import cv2
    from protosam_tpu.data import polyp as jpolyp
    from protosam_tpu.data import polyp_transforms as jtrans
    from protosam_tpu.eval import protosam_eval as jeval
    from protosam_tpu.utils.config import Config as JConfig
except ImportError:
    pass
from torch_parity import (dice, jax_coarse_params, jax_sam_params,
                          record_calls, seeded_state_dict)

from protosam_tpu_torch.data import polyp, polyp_transforms
from protosam_tpu_torch.data.prepare import resize_linear, resize_nearest
from protosam_tpu_torch.data.transforms import (rotation_matrix_2d,
                                                warp_affine)
from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.utils.config import Config

torch.set_num_threads(2)

FRAME = 256     # the SAM frame and the eval's sam_frame (input_size 256)


def _blobs(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([120 + 80 * np.sin(x / (9 + 3 * c) + rng.uniform(0, 6))
                    * np.cos(y / (11 + 2 * c)) for c in range(3)], axis=-1)
    return (img + rng.integers(0, 30, (h, w, 3))).clip(0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def polyp_root(tmp_path_factory):
    """Two datasets of 6 RGB images (120 x 160: a whole number of the
    bilinear warp's 16-pixel blocks) with disc masks, 4 train and 2 test
    each, written by cv2."""
    root = tmp_path_factory.mktemp("polyps")
    rng = np.random.default_rng(0)
    for ds in ["Kvasir", "CVC-ClinicDB"]:
        os.makedirs(root / ds / "images")
        os.makedirs(root / ds / "masks")
        names = [f"{ds.lower()}_{i}" for i in range(6)]
        for n in names:
            mask = np.zeros((120, 160), np.uint8)
            cy, cx = rng.integers(30, 90), rng.integers(40, 110)
            cv2.circle(mask, (int(cx), int(cy)), 25, 255, -1)
            img = _blobs(rng, 120, 160)
            img[mask > 0] = (img[mask > 0] * 0.5 + 100).astype(np.uint8)
            cv2.imwrite(str(root / ds / "images" / f"{n}.png"),
                        img[..., ::-1])
            cv2.imwrite(str(root / ds / "masks" / f"{n}.png"), mask)
        with open(root / ds / "split.txt", "w") as f:
            f.write("train:\n" + "\n".join(names[:4]) +
                    "\nval:\n\ntest:\n" + "\n".join(names[4:]) + "\n")
    return str(root)


def _same_item(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------ datasets


@pytest.mark.parametrize("sam_trans", [True, False], ids=["sam", "resize"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_items_match_jax(polyp_root, sam_trans, train):
    """Split lists, the normalisation and every item bit-equal to JAX's,
    in the SAM longest-side mode and the mean/std resize mode (a
    non-square frame)."""
    kw = dict(train=train, use_sam_trans=sam_trans, seed=3,
              image_size=FRAME if sam_trans else (96, 128))
    ours, theirs = polyp.PolypDataset(polyp_root, **kw), \
        jpolyp.PolypDataset(polyp_root, **kw)
    assert ours.images == theirs.images and ours.gts == theirs.gts
    assert len(ours) == len(theirs) == (8 if train else 4)
    assert (ours.mean, ours.std) == (theirs.mean, theirs.std)
    for i in range(len(ours)):
        _same_item(ours[i], theirs[i])


@pytest.mark.parametrize("mode", ["split", "dirs", "text"])
def test_get_support_matches_jax(polyp_root, tmp_path, mode):
    """The three support sources, drawn with one seed, as JAX draws."""
    kw = dict(train=True, image_size=FRAME, seed=7)
    ours, theirs = polyp.PolypDataset(polyp_root, **kw), \
        jpolyp.PolypDataset(polyp_root, **kw)
    args = dict(n_support=3)
    if mode == "dirs":
        args.update(support_image_dir=os.path.join(polyp_root, "Kvasir",
                                                   "images"),
                    support_mask_dir=os.path.join(polyp_root, "Kvasir",
                                                  "masks"))
    elif mode == "text":
        lst = tmp_path / "support.txt"
        lst.write_text("".join(f"{ours.images[i]} {ours.gts[i]}\n"
                               for i in (5, 1, 2)))
        args["text_file"] = str(lst)
    for _ in range(2):  # the generator moves on in step
        a, b = ours.get_support(**args), theirs.get_support(**args)
        assert a[2] == b[2]
        for x, y in zip(a[0] + a[1], b[0] + b[1]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_superpixel_episode_matches_jax(polyp_root):
    """``SuperpixPolypDataset`` with ``get_polyp_transform`` from one seed:
    the same superpixel, pair and pseudo-labels as JAX's."""
    kw = dict(train=True, image_size=FRAME, seed=1)
    ours = polyp.SuperpixPolypDataset(
        polyp_root, transforms=polyp_transforms.get_polyp_transform(
            np.random.RandomState(5))[0], **kw)
    theirs = jpolyp.SuperpixPolypDataset(
        polyp_root, transforms=jtrans.get_polyp_transform(
            np.random.RandomState(5))[0], **kw)
    for i in (0, 3):
        a, b = ours[i], theirs[i]
        assert a["superpix_label"] == b["superpix_label"]
        assert a["class_ids"] == b["class_ids"]
        np.testing.assert_array_equal(a["support_images"][0][0],
                                      b["support_images"][0][0])
        np.testing.assert_array_equal(a["query_images"][0],
                                      b["query_images"][0])
        np.testing.assert_array_equal(a["query_labels"][0],
                                      b["query_labels"][0])
        for k in ("fg_mask", "bg_mask"):
            np.testing.assert_array_equal(a["support_mask"][0][0][k],
                                          b["support_mask"][0][0][k])


def test_jpg_supports_raise(polyp_root, tmp_path):
    """JAX's directory mode also lists ``.jpg``; no JPEG decoder here."""
    imgs, masks = tmp_path / "images", tmp_path / "masks"
    imgs.mkdir()
    masks.mkdir()
    cv2.imwrite(str(imgs / "a.jpg"), np.zeros((8, 8, 3), np.uint8))
    cv2.imwrite(str(masks / "a.png"), np.zeros((8, 8), np.uint8))
    ds = polyp.PolypDataset(polyp_root, train=True, image_size=FRAME, seed=0)
    with pytest.raises(NotImplementedError, match="JPEG"):
        ds.get_support(n_support=1, support_image_dir=str(imgs),
                       support_mask_dir=str(masks))


# ---------------------------------------------------------- transforms


def _pair(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            (rng.uniform(size=(h, w)) > 0.5).astype(np.float32))


@pytest.mark.parametrize("name", ["ColorJitter", "RandomVerticalFlip",
                                  "RandomHorizontalFlip", "RandomAffinePair",
                                  "get_polyp_transform"])
def test_transforms_match_jax(name):
    """Each transform (and the composed training transform) under a seeded
    ``RandomState``, ten draws: bit-equal images and masks, dtypes kept."""
    for seed in range(10):
        img, mask = _pair(seed)
        if name == "get_polyp_transform":
            ours = polyp_transforms.get_polyp_transform(
                np.random.RandomState(seed))[0]
            theirs = jtrans.get_polyp_transform(
                np.random.RandomState(seed))[0]
        else:
            ours = getattr(polyp_transforms, name)(
                rng=np.random.RandomState(seed))
            theirs = getattr(jtrans, name)(rng=np.random.RandomState(seed))
        a, b = ours(img, mask), theirs(img, mask)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_affine_pair_at_ragged_widths():
    """At widths that are no whole number of 16-pixel blocks the affine
    pair's mask (nearest) is still bit-equal to JAX's, its image bit-equal
    on the blocks and within 2e-5 of the image's range (255) on the last
    W mod 16 columns, which cv2 warps in a scalar loop."""
    for seed, w in enumerate((150, 37, 9, 100)):
        img, mask = _pair(seed, 41, w)
        a = polyp_transforms.RandomAffinePair(rng=np.random.RandomState(seed))
        b = jtrans.RandomAffinePair(rng=np.random.RandomState(seed))
        (ia, ma), (ib, mb) = a(img, mask), b(img, mask)
        np.testing.assert_array_equal(ma, mb)
        cut = w // 16 * 16
        np.testing.assert_array_equal(ia[:, :cut], ib[:, :cut])
        np.testing.assert_allclose(ia[:, cut:], ib[:, cut:], rtol=0,
                                   atol=2e-5 * 255)


@pytest.mark.parametrize("quarter", range(4))
def test_hsv_matches_cv2(quarter):
    """RGB -> HSV on every RGB triple, HSV -> RGB on every (h < 180, s, v)
    triple (a quarter of R, and of h, a case): bit-equal to cv2's 8-bit
    conversions, in rows of whole 32-pixel blocks and in rows with a
    tail."""
    r, g, b = np.meshgrid(np.arange(64 * quarter, 64 * quarter + 64),
                          np.arange(256), np.arange(256), indexing="ij")
    rgb = np.stack([r, g, b], -1).astype(np.uint8).reshape(2048, 2048, 3)
    np.testing.assert_array_equal(polyp_transforms.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rgb.copy()
    hsv[..., 0] = (rgb[..., 0] - 64 * quarter) + 45 * quarter
    hsv = hsv.reshape(64, 65536, 3)[:45].reshape(-1, 2048, 3)
    np.testing.assert_array_equal(polyp_transforms.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    for w in (1, 17, 150):  # a tail of every row, or all tail
        part = hsv.reshape(-1, 3)[:w * 3000].reshape(3000, w, 3)
        np.testing.assert_array_equal(polyp_transforms.hsv_to_rgb(part),
                                      cv2.cvtColor(part, cv2.COLOR_HSV2RGB))
        rgbp = rgb.reshape(-1, 3)[:w * 3000].reshape(3000, w, 3)
        np.testing.assert_array_equal(polyp_transforms.rgb_to_hsv(rgbp),
                                      cv2.cvtColor(rgbp, cv2.COLOR_RGB2HSV))


def _shapes(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(2, 60, 2))
        yield h, w, (int(rng.integers(1, 300)), int(rng.integers(1, 150)))


@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4, 5, 30])
def test_resizes_match_cv2(channels):
    """``resize_linear`` / ``resize_nearest`` at (width, height) sizes,
    up and down, on slices and on channels-last images of every path's
    channel counts (1/3/4 and the others), bit-equal to ``cv2.resize``."""
    rng = np.random.default_rng(channels or 0)
    for h, w, dsz in _shapes(channels or 0, 60):
        shape = (h, w) if channels is None else (h, w, channels)
        x = (rng.standard_normal(shape) * 100).astype(np.float32)
        last = channels is not None
        want = cv2.resize(x, dsz, interpolation=cv2.INTER_LINEAR)
        wantn = cv2.resize(x, dsz, interpolation=cv2.INTER_NEAREST)
        if channels == 1:
            want, wantn = want[..., None], wantn[..., None]
        try:
            got = resize_linear(x, dsz, channels_last=last)
        except NotImplementedError:  # border runs past 15 columns
            assert channels in (3, 4) and dsz[0] > 15 * w
            continue
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (shape, dsz)
        np.testing.assert_array_equal(
            resize_nearest(x, dsz, channels_last=last), wantn)
    # slices (..., H, W) are resized one by one
    x = rng.standard_normal((2, 3, 37, 41)).astype(np.float32)
    got = resize_linear(x, (96, 70))
    for i in np.ndindex(2, 3):
        np.testing.assert_array_equal(got[i], cv2.resize(x[i], (96, 70)))


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 30])
def test_resize_exact_halving_matches_cv2(channels):
    """Both sides halved exactly: cv2 switches INTER_LINEAR to INTER_AREA's
    2 x 2 mean for the channel counts past 1/3/4; ``resize_linear``
    follows it, bit for bit, and the others keep their lerp."""
    rng = np.random.default_rng(channels)
    for h, w in ((512, 512), (64, 38), (6, 8)):
        x = (rng.standard_normal((h, w, channels)) * 100).astype(np.float32)
        want = cv2.resize(x, (w // 2, h // 2),
                          interpolation=cv2.INTER_LINEAR)
        if channels == 1:
            want = want[..., None]
        got = resize_linear(x, (w // 2, h // 2), channels_last=True)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (h, w, channels)


@pytest.mark.parametrize("size", [(96, 96), (13, 21), (40, 30)])
def test_resize_of_stacked_planes_matches_cv2(size):
    """A slice stack stored plane by plane (the (H, W, Z) view of a
    (Z, H, W) volume the ingest hands over) resizes as cv2 resizes the
    (H, W, Z) image, bit for bit, and comes back stored plane by plane."""
    rng = np.random.default_rng(size[0])
    vol = (rng.standard_normal((30, 40, 60)) * 100).astype(np.float32)
    view = vol.transpose(1, 2, 0)
    dense = np.ascontiguousarray(view)
    for interp, fn in ((cv2.INTER_LINEAR, resize_linear),
                       (cv2.INTER_NEAREST, resize_nearest)):
        want = cv2.resize(dense, size, interpolation=interp)
        got = fn(view, size, channels_last=True)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert got.transpose(2, 0, 1).flags.c_contiguous
        np.testing.assert_array_equal(fn(dense, size, channels_last=True),
                                      want)


def test_nearest_warp_matches_cv2():
    """``warp_affine(nearest=True)`` = ``cv2.warpAffine(INTER_NEAREST)`` of
    masks under the affine pair's maps, exact angles included."""
    rng = np.random.default_rng(0)
    for t in range(60):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        mask = (rng.standard_normal((h, w)) * 10).astype(np.float32)
        ang = float(rng.choice([0, 45, 90, 180])) if t % 4 == 0 \
            else rng.uniform(-90, 90)
        m = rotation_matrix_2d((w / 2, h / 2), ang, rng.uniform(0.75, 1.25))
        m[:, 2] += (rng.uniform(-0.1, 0.1) * w, rng.uniform(-0.1, 0.1) * h)
        want = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(
            warp_affine(mask[..., None], m, nearest=True)[..., 0], want)
    with pytest.raises(NotImplementedError, match="nearest"):
        warp_affine(np.zeros((4, 4, 3), np.float32), m, nearest=True)


# -------------------------------------------------------------- run_eval


def _cfg(cls, root):
    cfg = cls()
    cfg.dataset = "polyps"
    cfg.data_dirs = {"polyps": root}
    cfg.input_size = (FRAME, FRAME)
    cfg.modelname = "dinov2_t14"
    cfg.protosam_sam_ver = "vit_t"
    cfg.do_cca = True
    cfg.dtype = "float32"
    cfg.max_ccs = 4
    cfg.seed = 2
    return cfg


@pytest.fixture(scope="module")
def weights():
    coarse = FewShotSeg(image_size=FRAME, which_model="dinov2_t14")
    sam = build_sam("vit_t", image_size=FRAME)
    return seeded_state_dict(coarse, 0), seeded_state_dict(sam, 1)


@pytest.fixture(scope="module")
def jax_polyp_run(polyp_root, weights):
    """JAX's ``run_eval_polyp``, once, with its masks recorded."""
    csd, ssd = weights
    with pytest.MonkeyPatch.context() as mp:
        orig = jeval.build_sam
        mp.setattr(jeval, "build_sam",
                   lambda t, dtype, **kw: orig(t, dtype, FRAME, **kw))
        cfg = _cfg(JConfig, polyp_root)
        pipe = jeval.build_models(cfg, coarse_params=jax_coarse_params(csd),
                                  sam_params=jax_sam_params(ssd))
        masks = []
        record_calls(pipe, "forward", masks)
        result = jeval.run_eval_polyp(cfg, pipe=pipe)
    return result, np.stack(masks)


@pytest.fixture(scope="module")
def port_polyp_pipe(weights):
    csd, ssd = weights
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(protosam_eval, "SAM_IMAGE_SIZE", FRAME)
        return protosam_eval.build_models(_cfg(Config, ""), device="cpu",
                                          coarse_state=csd, sam_state=ssd)


def test_run_eval_polyp_matches_jax(polyp_root, jax_polyp_run,
                                    port_polyp_pipe):
    """Keys, cases and counts as JAX's; metrics within 1e-4 and every
    mask at Dice >= 0.99 against JAX's, through ``run_eval``."""
    want, jmasks = jax_polyp_run
    masks = []
    record_calls(port_polyp_pipe, "forward", masks)
    try:
        got = protosam_eval.run_eval(_cfg(Config, polyp_root),
                                     pipe=port_polyp_pipe)
    finally:
        del port_polyp_pipe.forward
    masks = np.stack(masks)
    assert set(got) == set(want)
    assert got["n_slices"] == want["n_slices"] == 4
    assert set(got["cases"]) == set(want["cases"]) == {"Kvasir",
                                                       "CVC-ClinicDB"}
    for case, row in want["cases"].items():
        assert abs(got["cases"][case]["meanDice"] - row["meanDice"]) <= 1e-4
    for key in ("mar_val_batches_meanDice", "mar_val_batches_meanPrec",
                "mar_val_al_batches_meanRec", "mar_val_al_batches_meanIOU"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    assert masks.shape == jmasks.shape == (4, FRAME, FRAME)
    assert min(dice(a, b) for a, b in zip(masks, jmasks)) >= 0.99
    # the weights make real masks: neither all empty nor all foreground
    assert 0.0 < float(masks.mean()) < 1.0
