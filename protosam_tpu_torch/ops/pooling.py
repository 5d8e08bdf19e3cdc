"""Pooling with torch defaults on the trailing (H, W) dims."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool2d(x: torch.Tensor, window: int,
               stride: int | None = None) -> torch.Tensor:
    """``F.avg_pool2d(x, window)`` on the trailing (H, W) dims of any rank:
    stride = window, no padding, floor mode (the ALP prototype pooling,
    reference models/alpmodule.py:114,118)."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), window, stride)
    return y.reshape(*lead, *y.shape[-2:])
