"""The port's data preparation (``data/prepare.py`` with
``native/felzenszwalb.cc``) against the JAX package's on the CPU, bit for
bit: Felzenszwalb, the foreground masks (one K3 call a volume in the port,
``cv2.connectedComponents`` a slice in JAX), the superpixel masking, the
resampling, the in-plane resize against ``cv2.resize`` and
``prepare_dataset`` end to end on JAX's 2-scan recipe
(``tests/test_prepare.py``).  The test marked ``cuda`` holds the card's
``superpix_volume`` to its CPU run."""

import json

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import cv2

    from protosam_tpu.data import nifti as jnifti
    from protosam_tpu.data import prepare as jprepare
except ImportError:
    pass

from protosam_tpu_torch.data import prepare
from protosam_tpu_torch.data.nifti import NiftiImage, read_nii
from protosam_tpu_torch.ops.cca import label_components

torch.set_num_threads(2)


def _blobs() -> np.ndarray:
    img = np.zeros((80, 80), np.float32)
    img[10:35, 10:35] = 10.0
    img[45:75, 45:75] = 20.0
    return img


def _noisy() -> np.ndarray:
    rng = np.random.default_rng(0)
    img = rng.normal(100, 20, (96, 112)).astype(np.float32)
    img[20:70, 30:90] += 120
    return img


@pytest.mark.parametrize("case,kw", [
    ("blobs", dict(scale=1.0, sigma=0.8, min_size=100)),
    ("noisy", dict()),
    ("noisy", dict(scale=4.0, sigma=0.0, min_size=20))])
def test_felzenszwalb_matches_jax(case, kw):
    img = _blobs() if case == "blobs" else _noisy()
    got = prepare.felzenszwalb(img, **kw)
    np.testing.assert_array_equal(got, jprepare.felzenszwalb(img, **kw))
    assert got.dtype == np.int32 and len(np.unique(got)) > 1


def _mask_volume() -> np.ndarray:
    """Slices: noise (many components), two equal squares in different row
    pairs with a hole in the second, empty, no background, one component,
    and two equal squares whose first pixels share a row."""
    rng = np.random.default_rng(1)
    vol = np.full((6, 48, 56), -5.0, np.float32)
    vol[0] = rng.normal(0, 1, (48, 56))
    vol[1, 4:14, 30:40] = 5
    vol[1, 20:30, 6:16] = 5
    vol[1, 24:27, 9:12] = -5
    vol[3] = 5
    vol[4, 10:40, 5:50] = 5
    vol[4, 20:25, 20:25] = -5
    vol[5, 8:16, 4:12] = 5
    vol[5, 8:16, 30:38] = 5
    return vol


@pytest.mark.parametrize("batched", [True, False],
                         ids=["fg_masks", "fg_mask_2d"])
def test_fg_masks_match_jax(batched):
    vol, thresh = _mask_volume(), 0.5
    want = np.stack([jprepare.fg_mask_2d(s, thresh) for s in vol])
    if batched:
        before = label_components.launches
        got = prepare.fg_masks(vol, thresh, device="cpu")
        assert label_components.launches == before  # the plain version
    else:
        got = np.stack([prepare.fg_mask_2d(s, thresh, device="cpu")
                        for s in vol])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert want[2].max() == 0 and want[3].min() == 1  # empty, full
    assert want[4][22, 22] == 1  # the hole filled


def test_superpix_masking_matches_jax():
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 9, (5, 24, 20)).astype(np.int32)
    masks = (rng.random((5, 24, 20)) > 0.4).astype(np.float32)
    masks[1] = 1  # no background: JAX's loop gives the first superpixel 0
    masks[2] = 0
    for s, m in zip(seg, masks):
        got = prepare.superpix_masking(s, m)
        np.testing.assert_array_equal(got, jprepare.superpix_masking(s, m))
    assert prepare.superpix_masking(seg[1], masks[1]).min() == 0


def test_superpix_volume_matches_jax():
    vol = _mask_volume() * 20 + np.random.default_rng(3).normal(
        0, 3, (6, 48, 56)).astype(np.float32)
    got = prepare.superpix_volume(vol, 10.0, min_size=30, device="cpu")
    want = jprepare.superpix_volume(vol, 10.0, min_size=30)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1


@pytest.mark.parametrize("is_label", [False, True], ids=["image", "label"])
def test_resample_volume_matches_jax(is_label):
    rng = np.random.default_rng(4)
    arr = rng.normal(size=(5, 30, 26)).astype(np.float32)
    if is_label:
        arr = np.digitize(arr, [-0.5, 0.3, 1.0]).astype(np.int16)
    spacing, new = (1.5, 1.5, 5.0), (1.25, 1.1, 7.7)
    got = prepare.resample_volume(NiftiImage(arr, spacing), new, is_label)
    want = jprepare.resample_volume(jnifti.NiftiImage(arr, spacing), new,
                                    is_label)
    assert got.array.dtype == want.array.dtype
    np.testing.assert_array_equal(got.array, want.array)
    assert got.spacing == want.spacing


@pytest.mark.parametrize("h,w,size", [
    (96, 96, 64), (45, 67, 131), (67, 45, 22), (100, 100, 50),
    (64, 64, 32), (30, 31, 67), (307, 307, 672), (13, 17, 29)],
    ids=lambda v: str(v))
def test_resize_matches_cv2(h, w, size):
    """cv2's float32 INTER_LINEAR and INTER_NEAREST, up and down, square and
    not, at widths that leave a tail past any vector width."""
    rng = np.random.default_rng(h * w + size)
    img = rng.normal(100, 30, (2, h, w)).astype(np.float32)
    lin = np.stack([cv2.resize(s, (size, size),
                               interpolation=cv2.INTER_LINEAR) for s in img])
    near = np.stack([cv2.resize(s, (size, size),
                                interpolation=cv2.INTER_NEAREST)
                     for s in img])
    got = prepare.resize_linear(img, size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, lin)
    np.testing.assert_array_equal(prepare.resize_nearest(img, size), near)


def test_resize_refuses_a_one_pixel_side():
    with pytest.raises(ValueError, match="2 x 2"):
        prepare.resize_linear(np.zeros((1, 9), np.float32), 4)


def _round_to_f32(exact) -> np.float32:
    """The float32 nearest a rational, ties to even."""
    from fractions import Fraction

    v = np.float32(float(exact))
    cands = (np.nextafter(v, np.float32(-np.inf)), v,
             np.nextafter(v, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.float32(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``_fma32`` against exact rational arithmetic: random operands, and
    sums a hair off a float32 halfway point, where rounding the float64 sum
    again would land on the other side."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = (rng.random(300) * 8 - 4).astype(np.float32)
    b = (rng.random(300) * 8 - 4).astype(np.float32)
    c = (rng.random(300) * 8 - 4).astype(np.float32)
    one, u = np.float32(1), np.float32(2.0 ** -23)
    tie_a = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    a = np.concatenate([a, [tie_a, -tie_a]]).astype(np.float32)
    b = np.concatenate([b, [one - u, one - u]]).astype(np.float32)
    c = np.concatenate([c, [one + u, -(one + u)]]).astype(np.float32)
    got = prepare._fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        assert g == _round_to_f32(exact), (x, y, z)
    assert got[-2] == one + u  # the float64 sum alone rounds to 1 + 2u


def _raw_scans(root):
    """JAX's 2-scan recipe (``tests/test_prepare.py``)."""
    indir = root / "in"
    indir.mkdir()
    rng = np.random.default_rng(0)
    for sid in [1, 2]:
        img = rng.normal(50, 10, (3, 48, 48)).astype(np.float32)
        lbl = np.zeros((3, 48, 48), np.int16)
        img[:, 10:35, 10:35] += 150
        lbl[:, 14:30, 14:30] = 1
        jnifti.write_nii(jnifti.NiftiImage(img, (2.5, 2.5, 7.7)),
                         indir / f"image_{sid}.nii.gz")
        jnifti.write_nii(jnifti.NiftiImage(lbl, (2.5, 2.5, 7.7)),
                         indir / f"label_{sid}.nii.gz")
    return indir


def test_prepare_dataset_matches_jax(tmp_path):
    indir = _raw_scans(tmp_path)
    kw = dict(image_size=64, new_spacing=(1.25, 1.25, 7.7))
    jprepare.prepare_dataset(str(indir), str(tmp_path / "jax"), "MR",
                             ["BG", "ORGAN"], **kw)
    prepare.prepare_dataset(str(indir), str(tmp_path / "port"), "MR",
                            ["BG", "ORGAN"], device="cpu", **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 8
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())
            continue
        want, got = read_nii(a, peel_info=False), read_nii(b, peel_info=False)
        assert got.array.dtype == want.array.dtype, name
        np.testing.assert_array_equal(got.array, want.array, err_msg=name)
        assert got.spacing == want.spacing
    sp = read_nii(tmp_path / "port" / "superpix-MIDDLE_1.nii.gz")
    assert sp.shape == (3, 64, 64) and sp.max() > 1


@pytest.mark.cuda
def test_superpix_volume_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K3 runs only there")
    vol = _mask_volume() * 20 + np.random.default_rng(3).normal(
        0, 3, (6, 48, 56)).astype(np.float32)
    before = label_components.launches
    got = prepare.superpix_volume(vol, 10.0, min_size=30, device="cuda")
    assert label_components.launches == before + 1  # one K3 call a volume
    np.testing.assert_array_equal(
        got, prepare.superpix_volume(vol, 10.0, min_size=30, device="cpu"))
