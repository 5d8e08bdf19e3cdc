"""Stateful predictor facade with the reference SamPredictor's API
(segment_anything/predictor.py:17-269; JAX ``models/sam/predictor.py``):
``set_image`` encodes once, ``predict`` decodes any prompt set against the
cached embedding, numpy in and numpy out.

The pipeline itself uses the batched path (``pipeline/protosam.py``);
this class serves users who drive SamPredictor directly.  It runs where
the model's weights live.
"""

from __future__ import annotations

import numpy as np
import torch

from protosam_tpu_torch.models.sam.sam import (MASK_THRESHOLD,
                                               encode_image_array,
                                               postprocess_masks)


class SamPredictor:
    def __init__(self, sam_model):
        self.model = sam_model
        self.reset_image()

    def reset_image(self) -> None:
        self.features = None
        self.original_size = None
        self.input_size = None
        self.is_image_set = False

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def set_image(self, image: np.ndarray, image_format: str = "RGB"):
        """image: (H, W, 3) uint8 (reference predictor.py:34-60)."""
        if image_format == "BGR":
            image = image[..., ::-1]
        self.features, self.input_size = encode_image_array(self.model,
                                                            image)
        self.original_size = image.shape[:2]
        self.is_image_set = True

    @torch.no_grad()
    def predict(self, point_coords=None, point_labels=None, box=None,
                mask_input=None, multimask_output: bool = True,
                return_logits: bool = False):
        """(masks (M, H, W), iou_predictions (M,), low_res (M, 4h, 4w)),
        reference predictor.py:92-170.  ``mask_input`` is a previous
        call's low-res logits, (1, 4h, 4w) or (4h, 4w)."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...)")
        dev = self.device
        scale_w = self.input_size[1] / self.original_size[1]
        scale_h = self.input_size[0] / self.original_size[0]

        if point_coords is not None:
            coords = np.asarray(point_coords, np.float32) * \
                np.asarray([scale_w, scale_h])
            coords = torch.as_tensor(coords.astype(np.float32),
                                     device=dev)[None]
            labels = torch.as_tensor(np.asarray(point_labels, np.int32),
                                     device=dev)[None]
        else:
            coords = torch.zeros((1, 0, 2), device=dev)
            labels = torch.zeros((1, 0), dtype=torch.int32, device=dev)
        boxes = None
        if box is not None:
            b = np.asarray(box, np.float32).reshape(-1, 4)
            b = b * np.asarray([scale_w, scale_h, scale_w, scale_h])
            boxes = torch.as_tensor(b[:1].astype(np.float32), device=dev)
        masks_in = None
        if mask_input is not None:
            side = 4 * (self.model.image_size // self.model.vit_patch_size)
            masks_in = torch.as_tensor(np.asarray(mask_input, np.float32),
                                       device=dev).reshape(1, 1, side, side)

        low_res, iou = self.model.decode(self.features, coords, labels,
                                         boxes, masks_in, multimask_output,
                                         boxes is None)
        masks = postprocess_masks(low_res.float(), self.input_size,
                                  self.original_size, self.model.image_size)
        masks = masks[0]
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        return (masks.cpu().numpy(), iou[0].cpu().numpy(),
                low_res[0].cpu().numpy())
