"""Model export, the counterpart of JAX ``utils/export.py`` (there
``jax.export``; the reference exports ONNX, segment_anything/utils/
onnx.py:17-144, unused by the pipeline but part of its API surface).

``export_decoder`` serializes SAM's prompt encoder + mask decoder as a
``torch.export`` program; ``load_exported`` rehydrates it for serving
without the Python model definition.  The decoder's LayerNorms are kernel
K1: the program records them as the ``ptk::layer_norm_rows`` operator
(``ops/norm.py``), which this module's import registers and which
launches K1 when the program runs on the card (as JAX's export keeps
its Pallas kernels as custom calls); everything else is PyTorch's.
"""

from __future__ import annotations

import io

import torch
from torch import nn

from protosam_tpu_torch.models.sam.sam import Sam
from protosam_tpu_torch.ops import norm  # noqa: F401 (registers K1's op)


class _Decoder(nn.Module):
    """decode(embedding, points, labels, box) -> (masks, iou): ``Sam.decode``
    over the prompt encoder and mask decoder alone (the program holds no
    image-encoder weights), ``multimask_output`` and ``pad_points=False``
    fixed, as JAX fixes them."""

    def __init__(self, sam_model, multimask_output: bool):
        super().__init__()
        self.prompt_encoder = sam_model.prompt_encoder
        self.mask_decoder = sam_model.mask_decoder
        self.multimask_output = multimask_output

    def forward(self, emb, coords, labels, boxes):
        # Sam.decode reads only these two modules
        return Sam.decode(self, emb, coords, labels, boxes, None,
                          self.multimask_output, False)


def export_decoder(sam_model, *, num_points: int = 2,
                   multimask_output: bool = False) -> bytes:
    """Serialize the decoder of ``sam_model`` for one image embedding
    (1, 256, g, g) f32, ``num_points`` points (1, P, 2) f32 with labels
    (1, P) int32 and a box (1, 4) f32, on the model's device."""
    grid = sam_model.image_size // sam_model.vit_patch_size
    dev = next(sam_model.parameters()).device
    args = (torch.zeros((1, 256, grid, grid), device=dev),
            torch.zeros((1, num_points, 2), device=dev),
            torch.ones((1, num_points), dtype=torch.int32, device=dev),
            torch.zeros((1, 4), device=dev))
    with torch.no_grad():
        program = torch.export.export(
            _Decoder(sam_model, multimask_output).eval(), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes):
    """Rehydrate an exported decoder: a callable (emb, coords, labels,
    boxes) -> (low_res_masks, iou)."""
    return torch.export.load(io.BytesIO(blob)).module()
