"""Device-side SAM prompt extraction from a coarse mask, batched over slices
and components: per-component top-confidence points, centroids and
dilation-boundary negative points (reference models/ProtoSAM.py:266-466),
padded to (B, K, ...) with validity masks so the decoder runs batched."""

from __future__ import annotations

from typing import NamedTuple

import torch

from protosam_tpu_torch.ops.cca import ComponentStats
from protosam_tpu_torch.ops.morphology import dilate


class PointPrompts(NamedTuple):
    """coords (B, K, P, 2) float32 xy; labels (B, K, P) int32 (1 fg, 0 bg,
    -1 pad); valid mirrors labels >= 0."""

    coords: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


def topk_points(prob: torch.Tensor, region: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k most confident pixels of ``prob`` inside binary ``region``
    (reference get_most_conf_points, models/ProtoSAM.py:266-289).

    prob and region (..., H, W) broadcast against each other.  Returns xy
    (..., k, 2) float32 and confidences (..., k), -inf where the region has
    fewer than k pixels.  Ties break at the lowest flat index (row-major):
    ``torch.argmax`` returns the first maximum.
    """
    w = prob.shape[-1]
    vals = torch.where(region > 0, prob, float("-inf")).flatten(-2).clone()
    idx, conf = [], []
    for _ in range(k):
        i = torch.argmax(vals, dim=-1, keepdim=True)
        conf.append(torch.gather(vals, -1, i))
        idx.append(i)
        vals.scatter_(-1, i, float("-inf"))
    idx = torch.cat(idx, dim=-1)
    xy = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return xy, torch.cat(conf, dim=-1)


def component_points(fg_prob: torch.Tensor, stats: ComponentStats,
                     num_points: int, point_mode: str) -> PointPrompts:
    """Positive point prompts per component; point_mode 'conf' (top-k
    confident), 'centroid' or 'both' (reference POINT_MODES)."""
    conf_xy, _ = topk_points(fg_prob[:, None], stats.onehot(), num_points)
    cent_xy = stats.centroids[:, :, None, :]
    if point_mode == "conf":
        coords = conf_xy
    elif point_mode == "centroid":
        coords = cent_xy
    elif point_mode == "both":
        coords = torch.cat([conf_xy, cent_xy], dim=2)
    else:
        raise ValueError(f"unknown point_mode: {point_mode}")
    b, k, p = coords.shape[:3]
    labels = torch.where(stats.valid[..., None], 1, -1).to(torch.int32)
    labels = labels.expand(b, k, p).contiguous()
    return PointPrompts(coords, labels, labels >= 0)


def negative_points(bg_prob: torch.Tensor, stats: ComponentStats,
                    num_neg: int = 1, kernel_size: int = 3,
                    dilation_iterations: int = 10) -> PointPrompts:
    """Per-component negative points on the dilation ring plus one global
    background point (reference models/ProtoSAM.py:361-366, 395-434).
    Returns (B, K, num_neg + 1, ...) with label 0 rows where valid."""
    onehot = stats.onehot().float()
    ring = dilate(onehot, kernel_size, dilation_iterations) - onehot
    ring_xy, ring_c = topk_points(bg_prob[:, None], ring, num_neg)
    glob_prob = torch.where(bg_prob >= 0.95, bg_prob, 0.0)
    glob_xy, glob_c = topk_points(glob_prob, glob_prob > 0, 1)
    b, k = stats.valid.shape
    glob_xy = glob_xy[:, None].expand(b, k, 1, 2)
    coords = torch.cat([ring_xy, glob_xy], dim=2)
    ring_valid = torch.isfinite(ring_c) & stats.valid[..., None]
    glob_valid = torch.isfinite(glob_c[:, 0])[:, None] & stats.valid
    valid = torch.cat([ring_valid, glob_valid[..., None]], dim=2)
    labels = torch.where(valid, 0, -1).to(torch.int32)
    coords = torch.where(valid[..., None], coords, 0.0)
    return PointPrompts(coords, labels, valid)


def build_sam_prompts(fg_prob: torch.Tensor, bg_prob: torch.Tensor,
                      stats: ComponentStats, *, num_points: int = 1,
                      point_mode: str = "both",
                      use_neg_points: bool = False) -> PointPrompts:
    """The padded point set per component (positive [+ negative])."""
    pos = component_points(fg_prob, stats, num_points, point_mode)
    if not use_neg_points:
        return pos
    neg = negative_points(bg_prob, stats)
    return PointPrompts(torch.cat([pos.coords, neg.coords], dim=2),
                        torch.cat([pos.labels, neg.labels], dim=2),
                        torch.cat([pos.valid, neg.valid], dim=2))
