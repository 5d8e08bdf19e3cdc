"""SAM oracle-baseline wrapper (reference models/SamWrapper.py:15-66; JAX
``models/samwrapper.py``).

Runs the automatic mask generator over the query image and returns the
generated mask with the best IoU against the ground-truth label: an oracle
upper bound, selected with ``base_model=SAM`` (reference
config_ssl_upload.py:94, call path ProtoSAM.py:170-179).
"""

from __future__ import annotations

import numpy as np
import torch

from protosam_tpu_torch.models.sam.amg import SamAutomaticMaskGenerator
from protosam_tpu_torch.models.sam.sam import encode_image_array


def get_iou(pred: np.ndarray, label: np.ndarray) -> float:
    """reference SamWrapper.py:8-13."""
    tp = np.logical_and(pred, label).sum()
    fp = np.logical_and(pred, 1 - label).sum()
    fn = np.logical_and(1 - pred, label).sum()
    return float(tp / max(tp + fp + fn, 1e-6))


class SamWrapper:
    """Encode once, generate every mask, keep the best against the label;
    runs where the model's weights live."""

    def __init__(self, sam_model, **amg_kwargs):
        self.sam = sam_model
        self.amg = SamAutomaticMaskGenerator(sam_model, **amg_kwargs)

    @torch.no_grad()
    def __call__(self, image: np.ndarray, image_labels: np.ndarray
                 ) -> np.ndarray:
        """image: (H, W, 3) uint8; image_labels: (H, W) binary GT.
        Returns the best-IoU generated mask (H, W) float32."""
        h, w = image.shape[:2]
        emb, _ = encode_image_array(self.sam, image)
        records = self.amg.generate(emb, (h, w))
        best, best_iou = np.zeros((h, w), np.float32), -1.0
        for rec in records:
            iou = get_iou(rec["segmentation"], image_labels)
            if iou > best_iou:
                best_iou = iou
                best = rec["segmentation"].astype(np.float32)
        return best
