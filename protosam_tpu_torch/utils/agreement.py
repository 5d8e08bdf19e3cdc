"""Mask-agreement harness (JAX ``utils/agreement.py``): the acceptance
criterion of >= 0.99 Dice between this framework's masks and the
reference's recorded masks.

Reference masks are whatever the PyTorch reference saved (NIfTI volumes
from validation.py:322-330, or ``.npy`` per-slice dumps); ours come from
the evaluation entry points.  ``dice_agreement_report`` pairs them by file
name and reports per-scan and overall agreement.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from protosam_tpu_torch.data.nifti import read_nii


def dice(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a) > 0
    b = np.asarray(b) > 0
    denom = a.sum() + b.sum()
    if denom == 0:
        return 1.0  # both empty: perfect agreement
    return float(2.0 * np.logical_and(a, b).sum() / denom)


def _load(path: str) -> np.ndarray:
    if path.endswith((".nii", ".nii.gz")):
        return read_nii(path)
    return np.load(path)


def dice_agreement_report(ours_dir: str, reference_dir: str,
                          pattern: str = "*.nii.gz") -> dict:
    """Pair files by basename between two prediction directories."""
    ours = {os.path.basename(p): p
            for p in glob.glob(os.path.join(ours_dir, pattern))}
    ref = {os.path.basename(p): p
           for p in glob.glob(os.path.join(reference_dir, pattern))}
    common = sorted(set(ours) & set(ref))
    per_scan = {name: dice(_load(ours[name]), _load(ref[name]))
                for name in common}
    overall = float(np.mean(list(per_scan.values()))) if per_scan else \
        float("nan")
    return {
        "per_scan": per_scan,
        "overall": overall,
        "n_pairs": len(common),
        "missing_in_ours": sorted(set(ref) - set(ours)),
        "missing_in_reference": sorted(set(ours) - set(ref)),
        "passes_099": bool(per_scan) and overall >= 0.99,
    }
