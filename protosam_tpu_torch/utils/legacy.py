"""Legacy validation helpers from the reference's util grab-bag (JAX
``utils/legacy.py``).

Reference ``util/utils.py:411-425`` (sliding-window confidence
segmentation) and ``:436-461`` (kneedle threshold selection).  These are
dead code in the reference, which no shipped config exercises, but they
complete the component inventory for users who drove them from their own
scripts.

Deviations from the reference, on purpose (as in JAX):

* ``sliding_window_confidence_segmentation`` there builds a
  ``sliding_window_view`` whose window spans the batch axis, and its
  ``[..., 0]`` tail index drops all but one spatial column; both are
  artifacts of the numpy stride trick.  This is the per-image 2-D box mean
  of its loop version (:391-409), zero-padded and centred.
* ``choose_threshold_kneedle`` there depends on the ``kneed`` package and
  writes matplotlib debug figures; this is a self-contained Kneedle
  (Satopaa et al. 2011) on the probability CDF with the same return
  contract (a threshold drawn from the histogram bin edges).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sliding_window_confidence_segmentation(conf: torch.Tensor,
                                           window_size: int = 3,
                                           threshold: float = 0.5
                                           ) -> torch.Tensor:
    """Binary segmentation by thresholding the local mean confidence.

    conf: (B, H, W) per-pixel confidence.  Returns int32 (B, H, W), 1 where
    the ``window_size``-square box mean (zeros outside, the reference's
    ``np.pad`` constant mode) exceeds ``threshold``.  Reference
    util/utils.py:411-425."""
    pad = window_size // 2
    summed = F.avg_pool2d(conf.float()[:, None], window_size, stride=1,
                          padding=pad, count_include_pad=True,
                          divisor_override=1)[:, 0]
    mean = summed / float(window_size * window_size)
    return (mean > threshold).to(torch.int32)


def choose_threshold_kneedle(p: np.ndarray) -> float:
    """A binarization threshold at the knee of the probability CDF.

    p: 1-D array of predicted probabilities.  Histograms ``p`` into
    ``min(100, len(p))`` bins, builds the CDF and returns the bin edge at
    the Kneedle knee of the (convex, increasing) CDF: the x of maximum
    deviation below the identity chord on the normalised curve.  Reference
    util/utils.py:436-461 (through kneed.KneeLocator)."""
    p = np.asarray(p).reshape(-1)
    n_bins = min(100, len(p))
    if n_bins < 2:
        return float(p[0]) if len(p) else 0.5
    hist, bin_edges = np.histogram(p, bins=n_bins)
    cdf = np.cumsum(hist / max(hist.sum(), 1))

    x = np.linspace(0.0, 1.0, n_bins)
    y = (cdf - cdf.min()) / max(cdf.max() - cdf.min(), 1e-12)
    knee_idx = int(np.argmax(x - y))
    return float(bin_edges[knee_idx])
