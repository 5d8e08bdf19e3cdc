"""Parity of the port's SAM (image encoder, prompt encoder, mask decoder) with
the JAX package (f32, CPU), on the same seeded weights: the port's
state_dict converted with ``convert_sam`` and back with the port's
converter."""

import functools

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.utils.torch_convert import convert_sam
except ImportError:
    pass

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.utils.convert import sam_state_dict
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


@pytest.fixture(scope="module")
def tiny_sam():
    """vit_t at 256 px: a 16² grid, so the windowed block pads 16 -> 28
    (two 14² windows a side) and the global block covers all 256 tokens."""
    model = build_sam("vit_t", image_size=256).eval()
    sd = seeded_state_dict(model, 1)
    model.load_state_dict(sd)
    jsam = jbuild_sam("vit_t", image_size=256)
    params = convert_sam({k: v.numpy() for k, v in sd.items()})
    encode = jax.jit(functools.partial(jsam.apply,
                                       method=jsam.encode_image))
    decode = jax.jit(functools.partial(jsam.apply, method=jsam.decode),
                     static_argnums=(6, 7))
    return model, params, encode, decode


def test_sam_converter_round_trip(tiny_sam):
    model, params, _, _ = tiny_sam
    back = sam_state_dict(params, model.encoder_global_attn_indexes)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), k)


def test_image_encoder_matches_jax(tiny_sam):
    model, params, encode, _ = tiny_sam
    x = np.random.default_rng(0).standard_normal(
        (2, 256, 256, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = np.asarray(encode({"params": params}, jnp.asarray(x)))
    assert got.shape == (2, 256, 16, 16)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("with_box,multimask,with_mask", [
    (True, False, False), (False, True, False), (True, True, True)])
def test_decoder_matches_jax(tiny_sam, with_box, multimask, with_mask):
    model, params, _, decode = tiny_sam
    rng = np.random.default_rng(1)
    n = 3
    emb = rng.standard_normal((n, 16, 16, 256)).astype(np.float32)
    coords = (rng.random((n, 2, 2)) * 256).astype(np.float32)
    labels = np.array([[1, 1], [1, -1], [0, 1]], np.int32)
    boxes = np.sort(rng.random((n, 2, 2)) * 256, axis=1).reshape(
        n, 4).astype(np.float32) if with_box else None
    masks = np.where(rng.random((n, 64, 64, 1)) > 0.5, 10.0, -8.0).astype(
        np.float32) if with_mask else None
    tt = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        low, iou = model.decode(
            tt(emb.transpose(0, 3, 1, 2)), tt(coords), tt(labels), tt(boxes),
            None if masks is None else tt(masks.transpose(0, 3, 1, 2)),
            multimask, boxes is None)
    jl, ji = decode({"params": params}, jnp.asarray(emb), jnp.asarray(coords),
                    jnp.asarray(labels),
                    None if boxes is None else jnp.asarray(boxes),
                    None if masks is None else jnp.asarray(masks),
                    multimask, boxes is None)
    np.testing.assert_allclose(low.numpy(), np.asarray(jl), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(iou.numpy(), np.asarray(ji), atol=5e-4,
                               rtol=1e-3)


@pytest.mark.cuda
def test_image_encoder_on_card_matches_cpu(cuda):
    """vit_t in f32 through kernels K1 and K4 (padded windows and the
    global block) against the CPU run."""
    model = build_sam("vit_t", image_size=256).eval()
    model.load_state_dict(seeded_state_dict(model, 1))
    x = torch.randn(2, 3, 256, 256, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model.encode_image(x)
        got = model.to(cuda).encode_image(x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-4)
