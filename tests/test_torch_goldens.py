"""Replay of the reference's recorded masks through the port's refine path.

``tests/goldens/ref_masks/`` holds 36 masks, 6 prompt configurations × 6
slices, recorded from the PyTorch reference's ``ProtoSAM.forward``
(models/ProtoSAM.py:536-678) on a seeded tiny SAM and deterministic
analytic inputs (``tools/record_reference_masks.py --synthetic``; the
manifest names both).  The JAX package replays them in
``test_agreement_recorded.py``, which needs the reference's own modules to
rebuild the seeded weights.  Here the port rebuilds them itself: its vit_t
``Sam`` at 256 px has the reference tiny SAM's state_dict keys, shapes and
order (``TINY_SAM_KW``), so the reference's draws (``tests/reference_compat
.build_tiny_torch_sam``: one generator seeded 42, ``randn(shape) * 0.05``
per key in state_dict order, ``* 3.2`` on the hypernetworks' last layer)
land on the same parameters.  Each slice then runs ``_refine_core`` on the
recorded inputs and must agree with its recorded mask at Dice >= 0.99, the
bar of ``test_recorded_agreement``.  f32 on the CPU, int8 off: the
reference has no int8.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from protosam_tpu_torch.models.sam.sam import Sam
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig

torch.set_num_threads(2)

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens" / "ref_masks"
MANIFEST = json.loads((GOLDEN_DIR / "manifest.json").read_text())
DICE_BAR = 0.99


def _linear(prefix):
    return [f"{prefix}.weight", f"{prefix}.bias"]


def reference_key_order(depth, n_decoder_layers=2, n_mask_tokens=4):
    """The reference tiny SAM's state_dict keys in order, written down from
    its module definitions (the vendored segment_anything): a module's own
    parameters and buffers first, then its children in the order its
    ``__init__`` assigns them."""
    keys = ["image_encoder.pos_embed",
            *_linear("image_encoder.patch_embed.proj")]
    for i in range(depth):
        b = f"image_encoder.blocks.{i}"
        keys += [*_linear(f"{b}.norm1"), f"{b}.attn.rel_pos_h",
                 f"{b}.attn.rel_pos_w", *_linear(f"{b}.attn.qkv"),
                 *_linear(f"{b}.attn.proj"), *_linear(f"{b}.norm2"),
                 *_linear(f"{b}.mlp.lin1"), *_linear(f"{b}.mlp.lin2")]
    keys += ["image_encoder.neck.0.weight", *_linear("image_encoder.neck.1"),
             "image_encoder.neck.2.weight", *_linear("image_encoder.neck.3")]
    pe = "prompt_encoder"
    keys += [f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
             *[f"{pe}.point_embeddings.{i}.weight" for i in range(4)],
             f"{pe}.not_a_point_embed.weight",
             *[k for i in (0, 1, 3, 4, 6)
               for k in _linear(f"{pe}.mask_downscaling.{i}")],
             f"{pe}.no_mask_embed.weight"]

    def attention(p):
        return [k for proj in ("q_proj", "k_proj", "v_proj", "out_proj")
                for k in _linear(f"{p}.{proj}")]

    t = "mask_decoder.transformer"
    for i in range(n_decoder_layers):
        lay = f"{t}.layers.{i}"
        keys += [*attention(f"{lay}.self_attn"), *_linear(f"{lay}.norm1"),
                 *attention(f"{lay}.cross_attn_token_to_image"),
                 *_linear(f"{lay}.norm2"), *_linear(f"{lay}.mlp.lin1"),
                 *_linear(f"{lay}.mlp.lin2"), *_linear(f"{lay}.norm3"),
                 *_linear(f"{lay}.norm4"),
                 *attention(f"{lay}.cross_attn_image_to_token")]
    keys += [*attention(f"{t}.final_attn_token_to_image"),
             *_linear(f"{t}.norm_final_attn")]
    d = "mask_decoder"
    keys += [f"{d}.iou_token.weight", f"{d}.mask_tokens.weight",
             *_linear(f"{d}.output_upscaling.0"),
             *_linear(f"{d}.output_upscaling.1"),
             *_linear(f"{d}.output_upscaling.3")]
    for i in range(n_mask_tokens):
        keys += [k for j in range(3)
                 for k in _linear(f"{d}.output_hypernetworks_mlps.{i}"
                                  f".layers.{j}")]
    keys += [k for j in range(3)
             for k in _linear(f"{d}.iou_prediction_head.layers.{j}")]
    return keys


def tiny_sam_kw():
    # imported here, not at collection: where only the `cuda` tests run
    # (``--noconftest``), ``tests`` need not be importable
    from tests.reference_compat import TINY_SAM_KW

    return TINY_SAM_KW


def tiny_sam():
    """The port's vit_t Sam at 256 px: ``TINY_SAM_KW``'s encoder."""
    kw = tiny_sam_kw()
    return Sam(encoder_embed_dim=kw["embed_dim"],
               encoder_depth=kw["depth"], encoder_num_heads=kw["num_heads"],
               encoder_global_attn_indexes=kw["global_attn_indexes"],
               image_size=kw["image_size"]).eval()


def reference_draws(sam):
    """``build_tiny_torch_sam``'s weights (``reference_compat.py:336-348``)
    drawn over the port's state_dict, which must be in the reference's
    order."""
    g = torch.Generator().manual_seed(42)
    sd = {}
    for k, v in sam.state_dict().items():
        scale = 3.2 if ("output_hypernetworks_mlps" in k
                        and ".layers.2." in k) else 0.05
        sd[k] = torch.randn(v.shape, generator=g) * scale
    return sd


@pytest.fixture(scope="module")
def seeded_sam():
    sam = tiny_sam()
    sam.load_state_dict(reference_draws(sam))
    return sam


def test_state_dict_order_is_the_reference_order():
    assert list(tiny_sam().state_dict()) == reference_key_order(
        tiny_sam_kw()["depth"])


def dice(a, b):
    a, b = a > 0, b > 0
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * (a & b).sum() / den


@pytest.mark.parametrize("tag", list(MANIFEST["configs"]))
def test_recorded_masks_replay_through_the_port(seeded_sam, tag):
    from tests.reference_compat import synthetic_agreement_case

    cfg = MANIFEST["configs"][tag]
    pipe = ProtoSAM(None, seeded_sam, ProtoSAMConfig(
        image_size=(256, 256), max_ccs=8, use_cca=cfg["use_cca"],
        use_points=cfg["use_points"], use_bbox=cfg["use_bbox"],
        use_mask=cfg["use_mask"], use_neg_points=cfg["use_neg_points"],
        point_mode=cfg["point_mode"],
        num_points_for_sam=cfg["num_points_for_sam"],
        # recorded through the reference's uint8 cast of the mask prompt
        # (ProtoSAM.py:479)
        mask_prompt_uint8_wrap=cfg["use_mask"]))
    assert len(cfg["files"]) == MANIFEST["n_slices"] == 6
    dices = []
    for i, name in enumerate(cfg["files"]):
        qry, logits = synthetic_agreement_case(i)
        with torch.no_grad():
            pred, _ = pipe._refine_core(torch.from_numpy(qry),
                                        torch.from_numpy(logits))
        want = np.load(GOLDEN_DIR / name)
        got = pred[0].numpy()
        assert got.shape == want.shape
        dices.append(dice(got, want))
    assert min(dices) >= DICE_BAR, dict(zip(cfg["files"], dices))
