"""CLAHE without cv2 (``data/clahe.py``) against
``cv2.createCLAHE(clipLimit, tileGridSize=(7, 7)).apply`` bit for bit, and
the CLAHE datasets (``MedicalVolumeDataset`` and ``SuperpixelDataset``
with ``use_clahe=True``) against JAX's on a synthetic CHAOS-T2 fold
(``tests/synthetic_data.py``)."""

import numpy as np
import pytest

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import cv2

    from protosam_tpu.data import medical as jmedical
    from protosam_tpu.data import superpixel as jsuperpixel
    from tests.synthetic_data import HW, make_dataset
except ImportError:
    pass

from protosam_tpu_torch.data import medical, superpixel
from protosam_tpu_torch.data.clahe import clahe


def _slice(kind: str, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(h * w)
    if kind == "noise":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w), 77, np.uint8)
    if kind == "smooth":
        yy, xx = np.mgrid[:h, :w]
        return (128 + 100 * np.sin(yy / 17) * np.cos(xx / 23)).astype(
            np.uint8)
    # intensities past 255 wrap in numpy's cast, as JAX's input does
    return rng.normal(200, 80, (h, w)).astype(np.float32).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "flat", "smooth", "wrap"])
@pytest.mark.parametrize("clip", [2.0, 4.0])
@pytest.mark.parametrize("h,w", [(256, 256), (672, 672), (255, 301)])
def test_clahe_matches_cv2(h, w, clip, kind):
    img = _slice(kind, h, w)
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(7, 7)).apply(img)
    got = clahe(img, clip)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_clahe_stack_and_no_clip_match_cv2():
    """A (Z, H, W) stack is each slice on its own; clip 0 is no clipping;
    a grid of other than 7 x 7 tiles."""
    stack = np.stack([_slice(k, 90, 77) for k in ("noise", "wrap",
                                                  "smooth")])
    for clip, grid in ((0.0, (7, 7)), (3.0, (4, 6))):
        got = clahe(stack, clip, grid)
        for s, g in zip(stack, got):
            want = cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(s)
            np.testing.assert_array_equal(g, want)
    with pytest.raises(TypeError, match="uint8"):
        clahe(stack.astype(np.float32), 2.0)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("chaos")))


@pytest.mark.parametrize("which", ["medical", "superpixel"])
def test_clahe_datasets_match_jax(data_dir, which):
    """Every slice's image within 1e-4 of JAX's (the resize is
    ``F.interpolate`` against cv2's), the labels equal."""
    if which == "medical":
        kw = dict(which_dataset="CHAOST2", base_dir=data_dir, idx_split=0,
                  image_size=80, use_clahe=True)
        ours, theirs = medical.MedicalVolumeDataset(**kw), \
            jmedical.MedicalVolumeDataset(**kw)
        pairs = [(ours[i]["image"], theirs[i]["image"], ours[i]["label"],
                  theirs[i]["label"]) for i in range(len(ours))]
    else:
        kw = dict(which_dataset="CHAOST2", base_dir=data_dir, idx_split=0,
                  mode="train", image_size=HW, transforms=None,
                  use_clahe=True, seed=0)
        ours, theirs = superpixel.SuperpixelDataset(**kw), \
            jsuperpixel.SuperpixelDataset(**kw)
        assert ours.clahe_clip == 4.0
        pairs = [(a["img"], b["img"], a["lb"], b["lb"])
                 for a, b in zip(ours.actual_dataset, theirs.actual_dataset)]
    assert len(pairs) == len(theirs.actual_dataset) > 0
    for img, jimg, lb, jlb in pairs:
        np.testing.assert_allclose(img, jimg, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(lb, jlb)
