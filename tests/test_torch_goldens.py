"""Replay of the reference's recorded masks through the port's refine path.

``tests/goldens/ref_masks/`` holds 36 masks, 6 prompt configurations × 6
slices, recorded from the PyTorch reference's ``ProtoSAM.forward``
(models/ProtoSAM.py:536-678) on a seeded tiny SAM and deterministic
analytic inputs (``tools/record_reference_masks.py --synthetic``; the
manifest names both).  The JAX package replays them in
``test_agreement_recorded.py``, which needs the reference's own modules to
rebuild the seeded weights.  Here the port rebuilds them itself
(``protosam_tpu_torch/utils/synthetic.py``, which the card's replay,
``tools/replay_goldens.py``, shares): its vit_t ``Sam`` at 256 px has the
reference tiny SAM's state_dict keys, shapes and order (``TINY_SAM_KW``),
so the reference's draws (``tests/reference_compat.build_tiny_torch_sam``:
one generator seeded 42, ``randn(shape) * 0.05`` per key in state_dict
order, ``* 3.2`` on the hypernetworks' last layer) land on the same
parameters.  Each slice then runs ``_refine_core`` on the
recorded inputs and must agree with its recorded mask at Dice >= 0.99, the
bar of ``test_recorded_agreement``.  f32 on the CPU, int8 off: the
reference has no int8.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.synthetic import (TINY_SAM_KW,
                                                reference_key_order,
                                                seeded_tiny_sam,
                                                synthetic_agreement_case,
                                                tiny_sam)

torch.set_num_threads(2)

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens" / "ref_masks"
MANIFEST = json.loads((GOLDEN_DIR / "manifest.json").read_text())
DICE_BAR = 0.99


@pytest.fixture(scope="module")
def seeded_sam():
    return seeded_tiny_sam()


def test_state_dict_order_is_the_reference_order():
    assert list(tiny_sam().state_dict()) == reference_key_order(
        TINY_SAM_KW["depth"])


def test_package_recipe_is_the_recording_recipe():
    """The package's copy of the recording's tiny-SAM shape and inputs
    (``utils/synthetic.py``, which the card's replay uses) is the one in
    ``tests/reference_compat.py`` that recorded the masks."""
    from tests import reference_compat

    assert TINY_SAM_KW == reference_compat.TINY_SAM_KW
    for i in range(MANIFEST["n_slices"]):
        for got, want in zip(synthetic_agreement_case(i),
                             reference_compat.synthetic_agreement_case(i)):
            np.testing.assert_array_equal(got, want)


def dice(a, b):
    a, b = a > 0, b > 0
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * (a & b).sum() / den


@pytest.mark.parametrize("tag", list(MANIFEST["configs"]))
def test_recorded_masks_replay_through_the_port(seeded_sam, tag):
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
