"""Connected-component analysis on the device, replacing cv2.

``label_components`` gives each foreground pixel the minimum flat index of
its 8-connected component (kernel K3 on the card).  That index is the
component's first pixel in row-major scan order, which is the order cv2
numbers components, so relabelling the roots 1..N in ascending order
matches ``cv2.connectedComponentsWithStats(connectivity=8)`` for up to
``max_ccs`` components.  Stats are padded to ``max_ccs`` rows with a
validity mask.  Every function takes a batch of slices (B, H, W).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from protosam_tpu_torch import kernels

BIG = 2**30


class ComponentStats(NamedTuple):
    """Padded per-component statistics of B slices (background excluded).

    labels:    (B, H, W) int32 — 0 background, 1..K component ids (cv2 order).
    num:       (B,) int32 — components found (may exceed max_ccs).
    valid:     (B, K) bool — stats row i describes component i+1.
    areas:     (B, K) int32 pixel counts.
    bboxes:    (B, K, 4) int32 (min_x, min_y, max_x, max_y), inclusive.
    centroids: (B, K, 2) float32 (x, y) mean pixel coordinates.
    """

    labels: torch.Tensor
    num: torch.Tensor
    valid: torch.Tensor
    areas: torch.Tensor
    bboxes: torch.Tensor
    centroids: torch.Tensor

    def onehot(self) -> torch.Tensor:
        """(B, K, H, W) bool: slot i is component i + 1's mask."""
        k = self.valid.shape[1]
        ids = torch.arange(1, k + 1, dtype=torch.int32,
                           device=self.labels.device)
        return self.labels[:, None] == ids[None, :, None, None]


def label_components_plain(mask: torch.Tensor) -> torch.Tensor:
    """K3's plain version: 3×3 neighbour-min restricted to the foreground,
    then pointer jumping ``L = L[L]``, until nothing changes."""
    b, h, w = mask.shape
    fg = mask != 0
    idx = torch.arange(h * w, device=mask.device).reshape(1, h, w)
    lbl = torch.where(fg, idx, BIG).to(torch.int64)
    while True:
        nb = -F.max_pool2d(-lbl.double().unsqueeze(1), 3, 1, 1)
        new = torch.where(fg, nb.squeeze(1).long(), BIG)
        flat = new.reshape(b, -1)
        jumped = torch.gather(flat, 1, flat.clamp(max=h * w - 1))
        new = torch.where(fg, jumped.reshape(b, h, w), BIG)
        if torch.equal(new, lbl):
            return lbl.to(torch.int32)
        lbl = new


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Root labels of (B, H, W) masks (nonzero = foreground): int32, BIG on
    background, the component's minimum flat index on foreground.  Kernel
    K3 (``csrc/cca.cu``) on a CUDA tensor, the plain version on a CPU
    tensor."""
    if mask.device.type == "cpu":
        return label_components_plain(mask)
    b, h, w = mask.shape
    if b * h * w >= BIG:
        raise ValueError(f"cca_label: {b}x{h}x{w} pixels exceed 2^30")
    fg = (mask != 0).to(torch.uint8).contiguous()
    scratch = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    out = torch.empty_like(scratch)
    dev = kernels.check_cuda("cca_label", fg, scratch, out)
    kernels.launch("ptk_cca_label", fg.data_ptr(), scratch.data_ptr(),
                   out.data_ptr(), b, h, w, device=dev)
    label_components.launches += 1
    return out


label_components.launches = 0


def connected_components(mask: torch.Tensor,
                         max_ccs: int = 8) -> ComponentStats:
    """``cv2.connectedComponentsWithStats`` plus the reference's per-CC
    bbox/centroid extraction, for (B, H, W) masks."""
    b, h, w = mask.shape
    flat = label_components(mask).reshape(b, -1)
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device)
    root_vals = torch.where((flat == idx) & (flat < BIG), flat, BIG)
    num = (root_vals < BIG).sum(dim=1).to(torch.int32)
    # the first max_ccs roots in ascending flat-index (cv2 scan) order;
    # components beyond max_ccs fall back to label 0
    roots = torch.topk(root_vals, max_ccs, dim=1, largest=False).values
    ids = torch.arange(1, max_ccs + 1, dtype=torch.int32, device=mask.device)
    # the roots are distinct, so ``hit`` is the one-hot of ``labels``
    hit = (flat[:, None, :] == roots[:, :, None]) & (roots[:, :, None] < BIG)
    labels = (hit * ids[None, :, None]).sum(dim=1).to(torch.int32)
    labels = labels.reshape(b, h, w)

    onehot = hit.reshape(b, max_ccs, h, w)
    valid = onehot.flatten(2).any(dim=2)
    areas = onehot.flatten(2).sum(dim=2).to(torch.int32)
    ys = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=mask.device)[None, :]
    min_x = torch.where(onehot, xs, BIG).amin(dim=(2, 3))
    max_x = torch.where(onehot, xs, -1).amax(dim=(2, 3))
    min_y = torch.where(onehot, ys, BIG).amin(dim=(2, 3))
    max_y = torch.where(onehot, ys, -1).amax(dim=(2, 3))
    bboxes = torch.stack([min_x, min_y, max_x, max_y], dim=-1)
    denom = torch.clamp(areas, min=1).float()
    cx = torch.where(onehot, xs, 0).sum(dim=(2, 3)).float() / denom
    cy = torch.where(onehot, ys, 0).sum(dim=(2, 3)).float() / denom
    centroids = torch.stack([cx, cy], dim=-1)
    return ComponentStats(labels, num, valid, areas, bboxes, centroids)


def component_confidences(stats: ComponentStats, fg_probs: torch.Tensor,
                          pred: torch.Tensor) -> torch.Tensor:
    """Per-component confidence ``sum(fg_probs·(cc == j)) / (sum(pred) +
    1e-6)`` (reference util/utils.py:485-492).  fg_probs, pred (B, H, W);
    returns (B, K) float32, 0 on padded rows."""
    num = torch.where(stats.onehot(), fg_probs[:, None], 0.0).sum(dim=(2, 3))
    den = pred.sum(dim=(1, 2))[:, None] + 1e-6
    return torch.where(stats.valid, num / den, 0.0)


def keep_most_confident(stats: ComponentStats, conf: torch.Tensor
                        ) -> tuple[ComponentStats, torch.Tensor]:
    """The reference's ``cca`` mode (util/utils.py:496-541; JAX
    ``_keep_best_component``): per slice, the most confident component
    alone, in one slot, or none where no confidence is positive.  conf
    (B, K) -> (one-slot stats: labels 0/1, num and valid 0 where there is
    none, areas, bboxes and centroids of the argmax row; its confidence
    (B, 1), 0 where there is none)."""
    best = torch.argmax(conf, dim=1)                           # (B,)
    keep = torch.amax(conf, dim=1) > 0
    rows = torch.arange(conf.shape[0], device=conf.device)
    labels = ((stats.labels == (best + 1)[:, None, None])
              & keep[:, None, None]).to(torch.int32)
    take = lambda a: a[rows, best][:, None]
    kept = ComponentStats(labels, keep.to(torch.int32), keep[:, None],
                          take(stats.areas), take(stats.bboxes),
                          take(stats.centroids))
    return kept, take(conf) * keep[:, None]


def components(pred: torch.Tensor, fg_probs: torch.Tensor, max_ccs: int,
               best_only: bool) -> tuple[ComponentStats, torch.Tensor | None]:
    """Which components of the coarse masks ``pred`` (B, H, W) become
    prompts: all of the first ``max_ccs`` (confidence None), or with
    ``best_only`` the most confident alone (``keep_most_confident``, its
    confidence (B, 1) from ``fg_probs``)."""
    stats = connected_components(pred, max_ccs)
    if not best_only:
        return stats, None
    return keep_most_confident(stats,
                               component_confidences(stats, fg_probs, pred))
