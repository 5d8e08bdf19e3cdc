"""Parity of the port's CCA, component stats and SAM prompt extraction with
the JAX package: labels, stats and prompt coordinates must be exactly
equal.  The ``cuda`` tests hold kernel K3 to its plain version bit for
bit, and a rerun to the first run: K3 is a tiled union-find whose tile
borders, tile corners and long chains the mask classes below aim at."""

import types

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from protosam_tpu.ops import cca as jcca
    from protosam_tpu.ops import prompts as jprompts
    from protosam_tpu.ops.cca_pallas import label_components_pallas
    from protosam_tpu.pipeline.protosam import (
        _keep_best_component as j_keep_best)
except ImportError:
    pass

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.eval.alpnet_eval import coarse_predict
from protosam_tpu_torch.ops import cca as tcca
from protosam_tpu_torch.ops import prompts as tprompts
from protosam_tpu_torch.pipeline.protomedsam import ProtoMedSAM
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()  # f32 tests compare in full f32: no TF32 anywhere
    return torch.device("cuda")


def random_blobs(rng, h, w, n, r):
    mask = np.zeros((h, w), np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(n):
        cy, cx = rng.integers(r, h - r), rng.integers(r, w - r)
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return mask


def snake(h, w):
    m = np.zeros((h, w), np.uint8)
    for r in range(0, h, 4):
        m[r, :] = 1
        m[r:r + 5, w - 1 if (r // 4) % 2 == 0 else 0] = 1
    return m


def mask_batch(h=64, w=64, seed=0):
    """Blobs, a snake, noise (many components), an empty and a full mask."""
    rng = np.random.default_rng(seed)
    return np.stack([random_blobs(rng, h, w, n=4, r=7), snake(h, w),
                     (rng.random((h, w)) > 0.6).astype(np.uint8),
                     np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)])


def tile_corners(h, w, period, anti):
    """A checkerboard of period ``period``: squares that touch only at
    their corners, diagonally, NW-SE (``anti`` False) or NE-SW."""
    yy, xx = np.mgrid[:h, :w]
    a, b = (yy % period) < period // 2, (xx % period) < period // 2
    return ((a != b) if anti else (a == b)).astype(np.uint8)


def diagonal_line(h, w, anti):
    """A 1-pixel diagonal line from one corner across the whole image."""
    m = np.zeros((h, w), np.uint8)
    k = np.arange(min(h, w))
    m[k, w - 1 - k if anti else k] = 1
    return m


def vertical_snake(h, w):
    """One 1-pixel snake: every other column full height, joined
    alternately along the top and the bottom row."""
    m = np.zeros((h, w), np.uint8)
    m[:, ::2] = 1
    for j, x in enumerate(range(1, w - 1, 2)):
        m[0 if j % 2 else h - 1, x] = 1
    return m


def jax_stats(mask, max_ccs):
    return [jcca.connected_components(jnp.asarray(m, jnp.float32), max_ccs)
            for m in mask]


@pytest.mark.parametrize("seed", range(3))
def test_root_labels_match_jax(seed):
    masks = mask_batch(seed=seed)
    got = tcca.label_components(torch.from_numpy(masks)).numpy()
    for i, m in enumerate(masks):
        want = np.asarray(jcca._label_components_xla(jnp.asarray(m)))
        np.testing.assert_array_equal(got[i], want)


CORNER_CASES = [("corners", p, anti) for p in (16, 32, 64)
                for anti in (False, True)] + [("diagonal", 0, False),
                                              ("diagonal", 0, True)]


def tile_class(h, w, kind, period, anti):
    if kind == "corners":
        return tile_corners(h, w, period, anti)
    return diagonal_line(h, w, anti)


@pytest.mark.parametrize("size", [(64, 64), (48, 80)])
@pytest.mark.parametrize("kind,period,anti", CORNER_CASES)
def test_plain_labels_match_jax_kernel_on_tile_classes(size, kind, period,
                                                       anti):
    """K3's plain version against the JAX Pallas kernel (interpret mode) on
    the classes that cross K3's tile borders only diagonally."""
    mask = tile_class(*size, kind, period, anti)
    got = tcca.label_components(torch.from_numpy(mask[None])).numpy()[0]
    want = np.asarray(label_components_pallas(jnp.asarray(mask),
                                              interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_ccs", [4, 8])
def test_component_stats_match_jax(max_ccs):
    masks = mask_batch(seed=3)
    got = tcca.connected_components(torch.from_numpy(masks).float(),
                                    max_ccs)
    for i, want in enumerate(jax_stats(masks, max_ccs)):
        for field in tcca.ComponentStats._fields:
            np.testing.assert_array_equal(
                getattr(got, field)[i].numpy(),
                np.asarray(getattr(want, field)), err_msg=field)


def test_component_confidences_match_jax():
    masks = mask_batch(seed=4).astype(np.float32)
    probs = np.random.default_rng(4).random(masks.shape).astype(np.float32)
    stats = tcca.connected_components(torch.from_numpy(masks), 8)
    got = tcca.component_confidences(stats, torch.from_numpy(probs),
                                     torch.from_numpy(masks)).numpy()
    for i, js in enumerate(jax_stats(masks, 8)):
        want = jcca.component_confidences(js, jnp.asarray(probs[i]),
                                          jnp.asarray(masks[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("point_mode,num_points,neg", [
    ("both", 1, False), ("conf", 3, False), ("centroid", 1, False),
    ("both", 2, True)])
def test_prompts_match_jax(point_mode, num_points, neg):
    masks = mask_batch(seed=5).astype(np.float32)
    rng = np.random.default_rng(5)
    fg = rng.random(masks.shape).astype(np.float32)
    fg[0, 10:20, 10:20] = 0.5  # ties break at the lowest flat index
    bg = 1.0 - fg
    stats = tcca.connected_components(torch.from_numpy(masks), 4)
    got = tprompts.build_sam_prompts(
        torch.from_numpy(fg), torch.from_numpy(bg), stats,
        num_points=num_points, point_mode=point_mode, use_neg_points=neg)
    for i, js in enumerate(jax_stats(masks, 4)):
        want = jprompts.build_sam_prompts(
            jnp.asarray(fg[i]), jnp.asarray(bg[i]), js,
            num_points=num_points, point_mode=point_mode,
            use_neg_points=neg)
        for field in ("coords", "labels", "valid"):
            np.testing.assert_array_equal(
                getattr(got, field)[i].numpy(),
                np.asarray(getattr(want, field)), err_msg=field)


def test_topk_tie_order_matches_jax():
    prob = np.full((12, 12), 0.25, np.float32)
    prob[5, 7] = prob[2, 9] = prob[8, 1] = 0.75
    region = np.ones((12, 12), np.float32)
    xy, conf = tprompts.topk_points(torch.from_numpy(prob),
                                    torch.from_numpy(region), 5)
    jxy, jconf = jprompts.topk_points(jnp.asarray(prob), jnp.asarray(region),
                                      5)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))


def test_keep_best_component_matches_jax():
    """``keep_most_confident`` keeps JAX's ``_keep_best_component`` in one
    slot: its slot 0, label map and count, and nothing in its other slots.
    Slice 1 has components but no positive confidence."""
    masks = mask_batch(seed=6).astype(np.float32)
    probs = np.random.default_rng(6).random(masks.shape).astype(np.float32)
    stats = tcca.connected_components(torch.from_numpy(masks), 4)
    conf = tcca.component_confidences(stats, torch.from_numpy(probs),
                                      torch.from_numpy(masks))
    conf[1] = 0.0
    got, got_conf = tcca.keep_most_confident(stats, conf)
    assert got.valid.shape == got_conf.shape == (len(masks), 1)
    for i, js in enumerate(jax_stats(masks, 4)):
        want, want_conf = j_keep_best(js, jnp.asarray(conf[i].numpy()))
        for field in tcca.ComponentStats._fields:
            w = np.asarray(getattr(want, field))
            if field not in ("labels", "num"):
                assert not w[1:].any(), field
                w = w[:1]
            np.testing.assert_array_equal(getattr(got, field)[i].numpy(), w,
                                          err_msg=field)
        want_conf = np.asarray(want_conf)
        assert not want_conf[1:].any()
        np.testing.assert_array_equal(got_conf[i].numpy(), want_conf[:1])


def _blob_logits(size, blobs):
    """(1, 2, H, W) coarse logits: background everywhere but the blobs
    (y0, x0, y1, x1, fg logit), whose fg probability is sigmoid(logit)."""
    fg = np.full((size, size), -8.0, np.float32)
    for y0, x0, y1, x1, v in blobs:
        fg[y0:y1, x0:x1] = v
    return torch.from_numpy(np.stack([np.zeros_like(fg), fg])[None])


# (blobs, the kept one's index or None); a logit of 40 gives probability 1.0
# exactly, so equal areas give equal confidences
KEEP_CASES = {
    # the confidence is a sum: the wide blob of probability 0.62 beats two
    # earlier ones of probability 1
    "several": ([(2, 2, 6, 6, 40.0), (3, 20, 6, 23, 40.0),
                 (14, 8, 20, 14, 0.5)], 2),
    "tie-first-wins": ([(3, 4, 7, 8, 40.0), (18, 16, 22, 20, 40.0)], 0),
    "empty": ([], None),
    "zero-confidence": ([(5, 5, 12, 12, 40.0)], None),
}


@pytest.mark.parametrize("case", list(KEEP_CASES))
def test_every_cca_path_keeps_the_same_component(case, monkeypatch):
    """The same coarse logits, in the SAM frame so that no path resamples
    them, through ProtoSAM's and ProtoMedSAM's prompts in 'cca' mode, the
    coarse-only pipeline and the ALPNet eval's ``coarse_predict``: each
    keeps the expected component, or none.  Consistent logits cannot give
    a component of confidence 0, so that case forces it at the rule."""
    blobs, best = KEEP_CASES[case]
    if case == "zero-confidence":
        monkeypatch.setattr(tcca, "component_confidences",
                            lambda stats, fg, pred: torch.zeros(
                                stats.valid.shape))
    size = 32
    logits = _blob_logits(size, blobs)
    want = torch.zeros((1, size, size))
    if best is not None:
        y0, x0, y1, x1, _ = blobs[best]
        want[0, y0:y1, x0:x1] = 1.0
    keep = want.flatten(1).any(dim=1)[:, None]
    qrys = torch.rand((1, 3, size, size), generator=torch.Generator()
                      .manual_seed(0))
    coarse = lambda *args, **kwargs: {"logits": logits}
    sam = types.SimpleNamespace(image_size=size)
    cfg = dict(image_size=(size, size), max_ccs=4, use_cca=True)

    ex = ProtoSAM(coarse, sam, ProtoSAMConfig(**cfg))._extract_prompts(
        qrys, logits)
    med = ProtoMedSAM(coarse, sam, ProtoSAMConfig(
        use_points=False, use_bbox=True, **cfg))._extract_prompts(qrys,
                                                                  logits)
    for prompts in (ex, med):
        assert torch.equal(prompts["valid"], keep)
        assert prompts["boxes"].shape == (1, 1, 4)
    assert torch.equal(ex["boxes"], med["boxes"])
    if best is not None:
        assert ex["boxes"][0, 0].tolist() == [x0, y0, x1 - 1, y1 - 1]
        # point_mode 'both': the kept component's centroid is point 1
        assert ex["coords"][0, 0, 1].tolist() == [(x0 + x1 - 1) / 2,
                                                  (y0 + y1 - 1) / 2]

    pred, conf = ProtoSAM(coarse, sam, ProtoSAMConfig(
        coarse_pred_only=True, **cfg))._forward_core(None, None, None, qrys,
                                                      None)
    assert torch.equal(pred, want)
    assert torch.equal(conf > 0, keep)
    got = coarse_predict(coarse, None, None, None, qrys, 2, True, 4, 4)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (256, 192), (1024, 1024)])
def test_cca_kernel_matches_plain_exactly(cuda, size):
    masks = torch.from_numpy(mask_batch(*size, seed=7)).to(cuda)
    got = tcca.label_components(masks)
    torch.cuda.synchronize()
    assert torch.equal(got, tcca.label_components_plain(masks))


def _kernel_equals_plain_twice(masks):
    got = tcca.label_components(masks)
    again = tcca.label_components(masks)
    torch.cuda.synchronize()
    assert torch.equal(got, tcca.label_components_plain(masks))
    # roots are component minima, so the order of the atomics cannot show
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(256, 256), (1024, 1024)])
@pytest.mark.parametrize("kind,period,anti", CORNER_CASES)
def test_cca_kernel_on_tile_corners_and_diagonals(cuda, size, kind, period,
                                                  anti):
    mask = tile_class(*size, kind, period, anti)
    _kernel_equals_plain_twice(torch.from_numpy(mask[None]).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["snake", "1000x1000", "33x17", "1x4096",
                                  "4096x1", "full", "empty", "b8"])
def test_cca_kernel_on_chains_sizes_and_batches(cuda, case):
    rng = np.random.default_rng(11)
    if case == "snake":  # one component crossing every tile row
        masks = vertical_snake(1024, 1024)[None]
    elif case in ("full", "empty"):
        masks = np.full((2, 1024, 1024), case == "full", np.uint8)
    elif case == "b8":
        masks = np.concatenate([mask_batch(1024, 1024, seed=8),
                                vertical_snake(1024, 1024)[None],
                                tile_corners(1024, 1024, 32, True)[None],
                                diagonal_line(1024, 1024, False)[None]])
    else:
        # ragged tiles: noise at two densities and a full mask
        h, w = map(int, case.split("x"))
        masks = np.stack([(rng.random((h, w)) > 0.5).astype(np.uint8),
                          (rng.random((h, w)) > 0.2).astype(np.uint8),
                          np.ones((h, w), np.uint8)])
    _kernel_equals_plain_twice(torch.from_numpy(masks).to(cuda))
