"""The bf16 build keeps DINOv2's ``pos_embed`` in f32, as JAX does
(``protosam_tpu/models/dinov2/vit.py:176-183, 245-247``: the f32 param is
resized in f32 and the result cast), so the bf16 port's features sit
closer to JAX's bf16 features than when the param was rounded to bf16
before the resize."""

import numpy as np
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from protosam_tpu.models.dinov2.vit import build_dinov2 as jbuild_dinov2
except ImportError:
    pass

from torch_parity import jax_coarse_params, seeded_state_dict

from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.layers import cast_compute

torch.set_num_threads(2)

SIZE = 126  # a 9² grid: the 37² pretrain pos_embed is resized


def _bf16_encoder(sd, round_pos_embed):
    model = FewShotSeg(image_size=SIZE, which_model="dinov2_t14").eval()
    model.load_state_dict(sd)
    if round_pos_embed:  # what the bf16 build did before: pos_embed in bf16
        pe = model.encoder.pos_embed
        pe.data = pe.data.to(torch.bfloat16).float()
    cast_compute(model.encoder, torch.bfloat16)
    return model.encoder


def test_bf16_build_keeps_pos_embed_f32_and_moves_toward_jax():
    model = FewShotSeg(image_size=SIZE, which_model="dinov2_t14")
    sd = seeded_state_dict(model, 0)
    enc = _bf16_encoder(sd, round_pos_embed=False)
    assert enc.pos_embed.dtype == torch.float32
    assert enc.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert enc.cls_token.dtype == torch.bfloat16

    x = np.random.default_rng(0).standard_normal(
        (2, 3, SIZE, SIZE)).astype(np.float32)
    want = jbuild_dinov2("dinov2_vitt14", dtype=jnp.bfloat16).apply(
        {"params": jax_coarse_params(sd)["encoder"]},
        jnp.asarray(x.transpose(0, 2, 3, 1)))["x_norm_patchtokens"]
    want = np.asarray(want, np.float32)
    gaps = {}
    for old in (False, True):
        with torch.no_grad():
            got = _bf16_encoder(sd, old)(torch.from_numpy(x))
        err = np.abs(got["x_norm_patchtokens"].numpy() - want)
        gaps[old] = (float(err.mean()), float(err.max()))
    print(f"bf16 DINOv2 patch tokens |port - JAX| mean / max: pos_embed "
          f"f32 {gaps[False][0]:.4e} / {gaps[False][1]:.4e}, rounded to "
          f"bf16 {gaps[True][0]:.4e} / {gaps[True][1]:.4e}")
    # bound: the bf16 tolerance of the port's bf16 tests, 2e-2 x
    # max(1, max |JAX|), on the max; the mean strictly below the rounded
    # build's, the max no larger
    assert gaps[False][1] <= 2e-2 * max(1.0, float(np.abs(want).max()))
    assert gaps[False][0] < gaps[True][0]
    assert gaps[False][1] <= gaps[True][1]
