"""Binary morphology on the device (replaces cv2.dilate in prompt
extraction)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, kernel_size: int = 3,
           iterations: int = 1) -> torch.Tensor:
    """``cv2.dilate(mask, ones((k, k)), iterations=n)`` for binary masks of
    shape (..., H, W); returns mask's dtype.  n iterations of a k×k square
    equal one (n(k-1)+1)² square, which separates into a vertical and a
    horizontal 1-D max."""
    eff = iterations * (kernel_size - 1) + 1
    pad = eff // 2
    lead = mask.shape[:-2]
    x = mask.float().reshape(-1, 1, *mask.shape[-2:])
    x = F.max_pool2d(x, (eff, 1), 1, (pad, 0))
    x = F.max_pool2d(x, (1, eff), 1, (0, pad))
    return x.reshape(*lead, *x.shape[-2:]).to(mask.dtype)
