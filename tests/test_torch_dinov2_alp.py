"""Parity of the port's DINOv2 encoder, ALP ops and FewShotSeg coarse model
with the JAX package (f32, CPU), on the same seeded weights: the port's
state_dict converted to JAX params with ``convert_dinov2``."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.dinov2.vit import build_dinov2 as jbuild_dinov2
    from protosam_tpu.ops import alp as jalp
    from protosam_tpu.utils.torch_convert import convert_dinov2
except ImportError:
    pass

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.ops import alp as talp
from protosam_tpu_torch.utils.convert import dinov2_state_dict
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


@pytest.fixture(scope="module")
def tiny_coarse():
    model = FewShotSeg(image_size=126, which_model="dinov2_t14").eval()
    sd = seeded_state_dict(model, 0)
    model.load_state_dict(sd)
    params = {"encoder": jax_dinov2_params(sd, "encoder.")}
    jmodel = JFewShotSeg(image_size=126, which_model="dinov2_t14")
    return model, jax.jit(jmodel.apply), params


def test_dinov2_features_match_jax(tiny_coarse):
    model, _, params = tiny_coarse
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 126, 126)).astype(np.float32)
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x))
    want = jbuild_dinov2("dinov2_vitt14").apply(
        {"params": params["encoder"]}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=3e-5, rtol=1e-5)


def test_dinov2_converter_round_trip(tiny_coarse):
    model, _, params = tiny_coarse
    back = dinov2_state_dict(params["encoder"], prefix="encoder.")
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("mask_token"):
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), k)


@pytest.mark.parametrize("fg_box", [(42, 84), (60, 66)],
                         ids=["gridconv+", "mask-fallback"])
def test_fewshot_logits_match_jax(tiny_coarse, fg_box):
    model, jmodel, params = tiny_coarse
    rng = np.random.default_rng(1)
    supp = rng.standard_normal((1, 3, 126, 126)).astype(np.float32)
    qry = rng.standard_normal((2, 3, 126, 126)).astype(np.float32)
    fg = np.zeros((1, 126, 126), np.float32)
    lo, hi = fg_box
    fg[:, lo:hi, lo:hi] = 1.0
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (supp, fg, 1 - fg, qry)))
        cached = model(*map(torch.from_numpy, (supp, fg, 1 - fg, qry)),
                       supp_fts=out["supp_fts"])
    want = jmodel({"params": params}, *map(jnp.asarray,
                                           (supp, fg, 1 - fg, qry)))
    assert out["supp_fts"].shape == (1, 64, 32, 32)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(cached["logits"].numpy(),
                               out["logits"].numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["gridconv", "gridconv+", "mask"])
def test_alp_score_matches_jax(mode):
    rng = np.random.default_rng(2)
    qry = rng.standard_normal((2, 32, 16, 16)).astype(np.float32)
    sup = rng.standard_normal((2, 32, 16, 16)).astype(np.float32)
    mask = np.zeros((2, 1, 16, 16), np.float32)
    mask[0, :, 3:11, 4:12] = 1.0
    mask[1, :, 8:16, 0:6] = 1.0
    got = talp.alp_score(*map(torch.from_numpy, (qry, sup, mask)), mode, 2,
                         0.95)
    want = jalp.alp_score(*map(jnp.asarray, (qry, sup, mask)), mode, 2, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_fewshot_on_card_matches_cpu(cuda):
    """FewShotSeg in f32 through kernels K1 and K2 against the CPU run."""
    model = FewShotSeg(image_size=126, which_model="dinov2_t14").eval()
    model.load_state_dict(seeded_state_dict(model, 0))
    g = torch.Generator().manual_seed(3)
    supp, qry = torch.randn(1, 3, 126, 126, generator=g), torch.randn(
        2, 3, 126, 126, generator=g)
    fg = torch.zeros(1, 126, 126)
    fg[:, 42:84, 42:84] = 1.0
    with torch.no_grad():
        want = model(supp, fg, 1 - fg, qry)["logits"]
        model.to(cuda)
        got = model(*(a.to(cuda) for a in (supp, fg, 1 - fg, qry)))["logits"]
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-4)
