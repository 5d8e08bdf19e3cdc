"""Dataset registry + normalization (reference dataloaders/dataset_utils.py).

The label tables and fold boundaries are data constants of the benchmark
datasets (CHAOS-T2, Synapse/SABS, LITS17) — reference
dataset_utils.py:14-55.

A copy of ``protosam_tpu/data/dataset_registry.py`` (numpy only), so that
this package needs no JAX."""

from __future__ import annotations

import numpy as np

DATASET_INFO = {
    "CHAOST2": {
        "PSEU_LABEL_NAME": ["BGD", "SUPFG"],
        "REAL_LABEL_NAME": ["BG", "LIVER", "RK", "LK", "SPLEEN"],
        "_SEP": [0, 4, 8, 12, 16, 20],
        "MODALITY": "MR",
        "LABEL_GROUP": {
            "pa_all": set(range(1, 5)),
            0: {1, 4},   # upper abdomen; kidneys held out
            1: {2, 3},   # lower abdomen
        },
    },
    "SABS": {
        "PSEU_LABEL_NAME": ["BGD", "SUPFG"],
        "REAL_LABEL_NAME": ["BGD", "SPLEEN", "KID_R", "KID_l", "GALLBLADDER",
                            "ESOPHAGUS", "LIVER", "STOMACH", "AORTA", "IVC",
                            "PS_VEIN", "PANCREAS", "AG_R", "AG_L"],
        "_SEP": [0, 6, 12, 18, 24, 30],
        "MODALITY": "CT",
        "LABEL_GROUP": {
            "pa_all": {1, 2, 3, 6},
            0: {1, 6},
            1: {2, 3},
        },
    },
    "LITS17": {
        "PSEU_LABEL_NAME": ["BGD", "SUPFG"],
        "REAL_LABEL_NAME": ["BGD", "LIVER", "TUMOR"],
        "_SEP": [0, 26, 52, 78, 104],
        "MODALITY": "CT",
        "LABEL_GROUP": {
            "pa_all": {1, 2},
            0: {1},
            1: {2},
            2: {1, 2},
        },
    },
}

# organ aliases used by the launch scripts (run_protosam.sh ORGAN=rk/lk/...)
ORGAN_CLASS = {
    "CHAOST2": {"liver": 1, "rk": 2, "lk": 3, "spleen": 4},
    "SABS": {"spleen": 1, "rk": 2, "lk": 3, "liver": 6},
}


class CircularList(list):
    """List with modular indexing/slicing (reference util/utils.py:628-650),
    used to wrap fold boundaries around the scan list."""

    def __getitem__(self, item):
        if isinstance(item, slice):
            start = item.start or 0
            stop = item.stop if item.stop is not None else len(self)
            return [self[i] for i in range(start, stop)]
        return super().__getitem__(item % len(self))


def mr_normalize(x: np.ndarray) -> np.ndarray:
    """Per-volume z-score (reference dataset_utils.py:101-102)."""
    return (x - x.mean()) / x.std()


def ct_statistics(arrays) -> tuple[float, float]:
    """Global CT mean/std over a set of volumes (dataset_utils.py:76-99)."""
    total, n = 0.0, 0
    for a in arrays:
        total += a.sum()
        n += a.size
    mean = total / n
    var = 0.0
    for a in arrays:
        var += np.sum((a - mean) ** 2)
    return float(mean), float((var / n) ** 0.5)


def get_normalize_op(modality: str, volumes=None, ct_mean=None, ct_std=None):
    if modality == "MR":
        return mr_normalize
    if ct_mean is None or ct_std is None:
        ct_mean, ct_std = ct_statistics(volumes)
    return lambda x: (x - ct_mean) / ct_std
