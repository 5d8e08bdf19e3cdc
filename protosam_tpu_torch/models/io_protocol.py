"""Input protocol of the coarse model (reference models/ProtoSAM.py:59-79).

Only ``ALPNetInput`` is ported; the SAM-wrapper oracle inputs and the
wrapper classes are not on the slice path.
"""

from __future__ import annotations

import torch

CONF_MODE = "conf"
CENTROID_MODE = "centroid"
BOTH_MODE = "both"
POINT_MODES = (CONF_MODE, CENTROID_MODE, BOTH_MODE)


def _stack(x) -> torch.Tensor:
    """Flatten the reference's way×shot list nesting (each leaf a batch-1
    tensor) into one (S, ...) tensor; pass tensors through."""
    if not isinstance(x, (list, tuple)):
        return torch.as_tensor(x)
    flat = [torch.as_tensor(leaf) for way in x
            for leaf in (way if isinstance(way, (list, tuple)) else [way])]
    return torch.cat(flat, dim=0)


class ALPNetInput:
    """Episode input: support_images (S, 3, H, W); support_labels (S, H, W)
    binary; query_images (N, 3, H, W).  ``supp_fts`` caches the support
    features once per volume."""

    def __init__(self, support_images, support_labels, query_images,
                 isval: bool = True, val_wsize: int = 2, supp_fts=None):
        self.supp_imgs = _stack(support_images)
        self.fore_mask = _stack(support_labels)
        self.back_mask = 1.0 - self.fore_mask
        self.qry_imgs = torch.as_tensor(query_images)
        self.isval = isval
        self.val_wsize = val_wsize
        self.supp_fts = supp_fts

    def set_query_images(self, query_images) -> None:
        self.qry_imgs = torch.as_tensor(query_images)

    def to(self, device) -> "ALPNetInput":
        self.supp_imgs = self.supp_imgs.to(device)
        self.fore_mask = self.fore_mask.to(device)
        self.back_mask = self.back_mask.to(device)
        self.qry_imgs = self.qry_imgs.to(device)
        if self.supp_fts is not None:
            self.supp_fts = self.supp_fts.to(device)
        return self
