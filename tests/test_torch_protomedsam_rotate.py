"""The port's rotation TTA and ProtoMedSAM against the JAX package on the
CPU: the rotate / reverse ops and the antialiased bilinear resize at 1e-5;
ProtoMedSAM's ``forward``, ``forward_volume`` and ``segment_all`` and
ProtoSAM's ``forward(degrees_rotate=15)`` on the same tiny weights
(dinov2_t14 at 126 px + SAM vit_t at 256, f32), at Dice >= 0.99 and scores
within 1e-4.  The ``cuda`` tests hold the card to the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.io_protocol import ALPNetInput as JALPNetInput
    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.ops import resize as jresize
    from protosam_tpu.ops import rotate as jrotate
    from protosam_tpu.pipeline import ProtoMedSAM as JProtoMedSAM
    from protosam_tpu.pipeline import ProtoSAM as JProtoSAM
    from protosam_tpu.pipeline import ProtoSAMConfig as JConfig
except ImportError:
    pass

from torch_parity import (dice, jax_coarse_params, jax_sam_params,
                                seeded_state_dict)

from protosam_tpu_torch.entry import build_pipeline, set_f32_precision
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.ops import resize as tresize
from protosam_tpu_torch.ops import rotate as trotate
from protosam_tpu_torch.pipeline.protomedsam import ProtoMedSAM
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ rotation ops


@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (2, 3, 64, 64),
                                   (1, 1, 63, 77), (1, 3, 63, 77)],
                         ids=["1ch-64", "3ch-64", "1ch-63x77", "3ch-63x77"])
@pytest.mark.parametrize("degrees", [0, 15, -15, 30, 90])
def test_rotate_ops_match_jax(shape, degrees):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    rot, size = trotate.rotate_tensor_no_crop(t(x), degrees)
    jrot, jsize = jrotate.rotate_tensor_no_crop(jnp.asarray(x), degrees)
    assert tuple(size) == tuple(int(v) for v in jsize)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), **TOL)
    back = trotate.reverse_tensor(rot, size[0], size[1], -degrees)
    jback = jrotate.reverse_tensor(jrot, int(jsize[0]), int(jsize[1]),
                                   -degrees)
    assert back.shape == jback.shape  # the reference's crop quirk included
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), **TOL)
    mode = "nearest" if shape[1] == 1 else "bilinear"
    np.testing.assert_allclose(
        trotate.rotate_expand(t(x), degrees, mode).numpy(),
        np.asarray(jrotate.rotate_expand(jnp.asarray(x), degrees, mode)),
        **TOL)
    np.testing.assert_allclose(
        trotate.rotate_no_expand(t(x), degrees).numpy(),
        np.asarray(jrotate.rotate_no_expand(jnp.asarray(x), degrees)), **TOL)


@pytest.mark.parametrize("src,dst", [((181, 181), (128, 128)),
                                     ((91, 77), (64, 64)),
                                     ((64, 64), (91, 91)),
                                     ((40, 40), (40, 40))],
                         ids=["down", "down-ragged", "up", "same"])
def test_resize_bilinear_antialias_matches_jax(src, dst):
    x = np.random.default_rng(1).standard_normal((2, 3, *src)).astype(
        np.float32)
    xt = t(x)
    got = tresize.resize_bilinear_antialias(xt, dst)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jresize.resize_bilinear_antialias(
            jnp.asarray(x), dst)), **TOL)
    assert (got is xt) == (src == dst)  # the input itself at its own size


# ------------------------------------------------------------- pipelines


@pytest.fixture(scope="module")
def tiny():
    coarse = FewShotSeg(image_size=126, which_model="dinov2_t14").eval()
    csd = seeded_state_dict(coarse, 0)
    coarse.load_state_dict(csd)
    sam = build_sam("vit_t", image_size=256).eval()
    ssd = seeded_state_dict(sam, 1)
    sam.load_state_dict(ssd)
    rng = np.random.default_rng(0)
    supp = rng.standard_normal((1, 3, 126, 126)).astype(np.float32)
    fg = np.zeros((1, 126, 126), np.float32)
    fg[:, 42:84, 42:84] = 1.0
    low = t(rng.standard_normal((3, 3, 21, 21), dtype=np.float32))
    vol = (tresize.resize_bilinear(low, (126, 126)) * 3.0).numpy()
    return (coarse, sam, jax_coarse_params(csd), jax_sam_params(ssd), supp,
            fg, vol)


def _pipes(tiny, cls, jcls, **flags):
    coarse, sam, jcp, jsp, *_ = tiny
    cfg = dict(image_size=(256, 256), max_ccs=4, **flags)
    return (cls(coarse, sam, ProtoSAMConfig(**cfg)),
            jcls(JFewShotSeg(image_size=126, which_model="dinov2_t14"), jcp,
                 jbuild_sam("vit_t", image_size=256), jsp, JConfig(**cfg)))


def _inputs(tiny, q):
    *_, supp, fg, vol = tiny
    return (ALPNetInput(t(supp), t(fg), t(vol[q])),
            JALPNetInput(jnp.asarray(supp), jnp.asarray(fg),
                         jnp.asarray(vol[q])))


def _assert_agree(preds, scores, jpreds, jscores):
    preds, jpreds = np.asarray(preds), np.asarray(jpreds)
    assert preds.shape == jpreds.shape
    assert np.asarray(scores).shape == np.asarray(jscores).shape
    for p, jp in zip(preds.reshape(-1, *preds.shape[-2:]),
                     jpreds.reshape(-1, *jpreds.shape[-2:])):
        assert dice(p, jp) >= 0.99
    np.testing.assert_allclose(np.asarray(scores), np.asarray(jscores),
                               atol=1e-4)


MEDSAM_FLAGS = dict(use_points=False, use_bbox=True)


def test_protomedsam_default_config_matches_jax(tiny):
    coarse, sam, jcp, jsp, *_ = tiny
    ours = ProtoMedSAM(coarse, sam).config
    theirs = JProtoMedSAM(None, jcp, None, jsp).config
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("use_cca", [True, False],
                         ids=["cca", "all-components"])
def test_protomedsam_forward_volume_matches_jax(tiny, use_cca):
    pipe, jpipe = _pipes(tiny, ProtoMedSAM, JProtoMedSAM, use_cca=use_cca,
                         **MEDSAM_FLAGS)
    vol = tiny[-1]
    inp, jinp = _inputs(tiny, slice(0, 1))
    preds, scores = pipe.forward_volume(t(vol), inp, slice_batch=2)
    jpreds, jscores = jpipe.forward_volume(jnp.asarray(vol), jinp,
                                           slice_batch=2)
    _assert_agree(preds, scores, jpreds, jscores)
    # a real prediction: neither empty nor everything
    assert 0.0 < float(preds.mean()) < 1.0


def test_protomedsam_forward_matches_jax(tiny):
    pipe, jpipe = _pipes(tiny, ProtoMedSAM, JProtoMedSAM, use_cca=True,
                         **MEDSAM_FLAGS)
    vol = tiny[-1]
    inp, jinp = _inputs(tiny, slice(1, 2))
    pred, scores = pipe.forward(t(vol[1:2]), inp)
    jpred, jscores = jpipe.forward(jnp.asarray(vol[1:2]), jinp)
    assert pred.shape == (126, 126)
    _assert_agree(pred[None], scores, np.asarray(jpred)[None], jscores)


@pytest.mark.parametrize("with_label", [False, True],
                         ids=["no-label", "best-vs-label"])
def test_protomedsam_segment_all_matches_jax(tiny, with_label):
    pipe, jpipe = _pipes(tiny, ProtoMedSAM, JProtoMedSAM, **MEDSAM_FLAGS)
    q = tiny[-1][2:3]
    gt = None
    if with_label:
        gt = np.zeros((126, 126), np.uint8)
        gt[40:80, 40:80] = 1
    mask, score = pipe.segment_all(t(q), gt)
    jmask, jscore = jpipe.segment_all(jnp.asarray(q), gt)
    assert mask.shape == (126, 126) and mask.dtype == np.float32
    assert dice(mask, jmask) >= 0.99
    np.testing.assert_allclose(score, jscore, atol=1e-4)


def test_protosam_rotation_tta_matches_jax(tiny):
    pipe, jpipe = _pipes(tiny, ProtoSAM, JProtoSAM, use_cca=True)
    vol = tiny[-1]
    inp, jinp = _inputs(tiny, slice(0, 1))
    pred, scores = pipe.forward(t(vol[:1]), inp, degrees_rotate=15)
    jpred, jscores = jpipe.forward(jnp.asarray(vol[:1]), jinp,
                                   degrees_rotate=15)
    assert pred.shape == (126, 126)
    _assert_agree(pred[None], scores, np.asarray(jpred)[None], jscores)
    assert 0.0 < float(pred.mean()) < 1.0
    # the query is restored on the input after the rotated coarse pass
    torch.testing.assert_close(inp.qry_imgs, t(vol[:1]), atol=0, rtol=0)


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_rotate_ops_on_card_match_cpu(cuda):
    g = torch.Generator().manual_seed(0)
    for shape in ((2, 1, 64, 64), (1, 3, 63, 77), (1, 2, 126, 126)):
        x = torch.randn(shape, generator=g)
        for degrees in (15, -15, 30):
            rot, size = trotate.rotate_tensor_no_crop(x, degrees)
            grot, gsize = trotate.rotate_tensor_no_crop(x.to(cuda), degrees)
            assert gsize == size
            torch.testing.assert_close(grot.cpu(), rot, **TOL)
            back = trotate.reverse_tensor(rot, *size, -degrees)
            gback = trotate.reverse_tensor(grot, *gsize, -degrees)
            torch.testing.assert_close(gback.cpu(), back, **TOL)


@pytest.mark.cuda
def test_protomedsam_and_rotation_on_card_match_cpu(cuda):
    """The tiny ProtoMedSAM (forward_volume) and ProtoSAM's rotation TTA
    in f32 through the kernels against the CPU run of the same weights."""
    cfg = ProtoSAMConfig(image_size=(256, 256), max_ccs=4)
    g = torch.Generator().manual_seed(0)
    vol = tresize.resize_bilinear(torch.randn(4, 3, 21, 21, generator=g),
                                  (126, 126)) * 3.0
    supp = torch.randn(1, 3, 126, 126, generator=g)
    fg = torch.zeros(1, 126, 126)
    fg[:, 42:84, 42:84] = 1.0
    outs = []
    for dev in (torch.device("cpu"), cuda):
        pipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                              image_size=126, sam_size=256,
                              dtype=torch.float32, config=cfg)
        med = ProtoMedSAM(pipe.coarse_model, pipe.sam_model,
                          dataclasses.replace(cfg, use_points=False))
        inp = ALPNetInput(supp, fg, vol[:1]).to(dev)
        p, s = med.forward_volume(vol.to(dev), inp, slice_batch=2)
        rp, rs = pipe.forward(vol[:1].to(dev), inp, degrees_rotate=15)
        outs.append([x.cpu() for x in (p, s, rp, rs)])
    (p, s, rp, rs), (gp, gs, grp, grs) = outs
    for a, b in zip(list(gp) + [grp], list(p) + [rp]):
        assert dice(a.numpy(), b.numpy()) >= 0.99
    torch.testing.assert_close(gs, s, atol=1e-4, rtol=0)
    torch.testing.assert_close(grs, rs, atol=1e-4, rtol=0)
