"""The port's ProtoSAM slice pipeline against the JAX pipeline on the same
weights and inputs: tiny DINOv2 at 126 px + SAM vit_t at 256, ``max_ccs=4``,
f32 on the CPU.  Masks must agree at Dice >= 0.99 and scores within 1e-4."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.io_protocol import ALPNetInput as JALPNetInput
    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.pipeline.protosam import ProtoSAM as JProtoSAM
    from protosam_tpu.pipeline.protosam import ProtoSAMConfig as JConfig
    from protosam_tpu.utils.torch_convert import convert_dinov2, convert_sam
except ImportError:
    pass

from protosam_tpu_torch.entry import build_pipeline, set_f32_precision
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.ops.resize import resize_bilinear
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card at full f32 precision; the kernels have no CPU mode, so
    without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()  # f32 tests compare in full f32: no TF32 anywhere
    return torch.device("cuda")


def seeded_state_dict(module, seed):
    """The synthetic fill plus N(0, 0.05²) on every entry, so biases are
    non-zero and attention is far from uniform."""
    rng = np.random.default_rng(seed + 100)
    return {k: v + torch.from_numpy(
                0.05 * rng.standard_normal(tuple(v.shape), dtype=np.float32))
            for k, v in synthetic_state_dict(module, seed).items()}


def jax_dinov2_params(sd, prefix=""):
    return convert_dinov2({k[len(prefix):]: v.numpy() for k, v in sd.items()
                           if k.startswith(prefix)})


def dice(a, b):
    a, b = a > 0.5, b > 0.5
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * (a & b).sum() / den


@pytest.fixture(scope="module")
def tiny_models():
    coarse = FewShotSeg(image_size=126, which_model="dinov2_t14").eval()
    csd = seeded_state_dict(coarse, 0)
    coarse.load_state_dict(csd)
    sam = build_sam("vit_t", image_size=256).eval()
    ssd = seeded_state_dict(sam, 1)
    sam.load_state_dict(ssd)
    jparams = ({"encoder": jax_dinov2_params(csd, "encoder.")},
               convert_sam({k: v.numpy() for k, v in ssd.items()}))
    rng = np.random.default_rng(0)
    supp = rng.standard_normal((1, 3, 126, 126)).astype(np.float32)
    fg = np.zeros((1, 126, 126), np.float32)
    fg[:, 42:84, 42:84] = 1.0
    # smooth slices: random 21² fields upsampled, as bench.py makes them
    low = torch.from_numpy(rng.standard_normal((4, 3, 21, 21),
                                               dtype=np.float32))
    vol = (resize_bilinear(low, (126, 126)) * 3.0).numpy()
    return coarse, sam, jparams, supp, fg, vol


@pytest.mark.parametrize("flags", [
    dict(use_cca=True), dict(use_cca=False),
    dict(use_cca=False, use_mask=True, use_points=False, use_bbox=False),
    dict(use_cca=False, use_mask=True, use_points=False, use_bbox=False,
         mask_prompt_uint8_wrap=True)],
    ids=["cca", "all-components", "mask-prompts", "mask-prompts-uint8"])
def test_pipeline_matches_jax(tiny_models, flags):
    coarse, sam, (jcp, jsp), supp, fg, vol = tiny_models
    pipe = ProtoSAM(coarse, sam, ProtoSAMConfig(
        image_size=(256, 256), max_ccs=4, **flags))
    preds, scores = pipe.forward_volume(
        torch.from_numpy(vol),
        ALPNetInput(torch.from_numpy(supp), torch.from_numpy(fg),
                    torch.from_numpy(vol[:1])), slice_batch=2)

    jpipe = JProtoSAM(JFewShotSeg(image_size=126, which_model="dinov2_t14"),
                      jcp, jbuild_sam("vit_t", image_size=256), jsp,
                      JConfig(image_size=(256, 256), max_ccs=4, **flags))
    jpreds, jscores = jpipe.forward_volume(
        jnp.asarray(vol), JALPNetInput(jnp.asarray(supp), jnp.asarray(fg),
                                       jnp.asarray(vol[:1])), slice_batch=2)
    jpreds, jscores = np.asarray(jpreds), np.asarray(jscores)
    assert preds.shape == jpreds.shape and scores.shape == jscores.shape
    for p, jp in zip(preds.numpy(), jpreds):
        assert dice(p, jp) >= 0.99
    np.testing.assert_allclose(scores.numpy(), jscores, atol=1e-4)
    # the weights make a real prediction: neither empty nor everything
    assert 0.0 < float(preds.mean()) < 1.0


def test_coarse_pred_only_matches_jax(tiny_models):
    coarse, sam, (jcp, jsp), supp, fg, vol = tiny_models
    cfg = dict(image_size=(256, 256), coarse_pred_only=True, max_ccs=4)
    inp = ALPNetInput(torch.from_numpy(supp), torch.from_numpy(fg),
                      torch.from_numpy(vol[:1]))
    pred, conf = ProtoSAM(coarse, sam, ProtoSAMConfig(**cfg)).forward(
        torch.from_numpy(vol[:1]), inp)
    jpipe = JProtoSAM(JFewShotSeg(image_size=126, which_model="dinov2_t14"),
                      jcp, jbuild_sam("vit_t", image_size=256), jsp,
                      JConfig(**cfg))
    jpred, jconf = jpipe.forward(
        jnp.asarray(vol[:1]), JALPNetInput(jnp.asarray(supp), jnp.asarray(fg),
                                           jnp.asarray(vol[:1])))
    assert dice(pred.numpy(), np.asarray(jpred)) >= 0.99
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=1e-4)


def test_forward_equals_forward_volume(tiny_models):
    coarse, sam, _, supp, fg, vol = tiny_models
    pipe = ProtoSAM(coarse, sam, ProtoSAMConfig(image_size=(256, 256),
                                                max_ccs=4))
    inp = ALPNetInput(torch.from_numpy(supp), torch.from_numpy(fg),
                      torch.from_numpy(vol[:1]))
    preds, scores = pipe.forward_volume(torch.from_numpy(vol[:3]), inp,
                                        slice_batch=2)
    pred, score = pipe.forward(torch.from_numpy(vol[2:3]), inp)
    np.testing.assert_array_equal(pred.numpy(), preds[2].numpy())
    np.testing.assert_allclose(score.numpy(), scores[2].numpy(), atol=1e-6)


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(cuda):
    """The tiny pipeline in f32 through all four kernels against the CPU
    run of the same weights and inputs."""
    cfg = ProtoSAMConfig(image_size=(256, 256), max_ccs=4)
    g = torch.Generator().manual_seed(0)
    low = torch.randn(4, 3, 21, 21, generator=g)
    vol = resize_bilinear(low, (126, 126)) * 3.0
    supp = torch.randn(1, 3, 126, 126, generator=g)
    fg = torch.zeros(1, 126, 126)
    fg[:, 42:84, 42:84] = 1.0
    outs = []
    for dev in (torch.device("cpu"), cuda):
        pipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                              image_size=126, sam_size=256,
                              dtype=torch.float32, config=cfg)
        inp = ALPNetInput(supp, fg, vol[:1]).to(dev)
        preds, scores = pipe.forward_volume(vol.to(dev), inp, slice_batch=2)
        outs.append((preds.cpu(), scores.cpu()))
    (p_cpu, s_cpu), (p_gpu, s_gpu) = outs
    for a, b in zip(p_gpu.numpy(), p_cpu.numpy()):
        assert dice(a, b) >= 0.99
    torch.testing.assert_close(s_gpu, s_cpu, atol=1e-4, rtol=0)
