"""PANet-style episodic pairing machinery (a copy of JAX
``data/pairing.py``: plain Python and numpy).

Behavioral spec: reference dataloaders/common.py:94-182 (ReloadPairedDataset,
Subset) and dataloaders/dev_customized_med.py:13-222 (fewshot_pairing,
med_fewshot) — class-indexed subsets are paired into support/query episodes
with reshufflable index tables.  Plain-python, numpy samples.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np


class Subset:
    """Class-restricted view of a dataset (reference common.py:155-182)."""

    def __init__(self, dataset, indices: Sequence[int], class_id=None):
        self.dataset = dataset
        self.indices = list(indices)
        self.class_id = class_id

    def __getitem__(self, idx):
        s = self.dataset[self.indices[idx]]
        if self.class_id is not None:
            s = dict(s)
            s["basic_class_id"] = self.class_id
        return s

    def __len__(self):
        return len(self.indices)


class ReloadPairedDataset:
    """Episode pairing across class subsets with reshuffle
    (reference common.py:94-153)."""

    def __init__(self, datasets: list, n_elements, curr_max_iters: int,
                 pair_based_transforms=None, seed: int | None = None):
        self.datasets = datasets
        self.n_datasets = len(datasets)
        self.n_elements = n_elements
        self.curr_max_iters = curr_max_iters
        self.pair_based_transforms = pair_based_transforms
        self.rng = random.Random(seed)
        self.update_index()

    def update_index(self):
        n_data = [len(d) for d in self.datasets]
        if isinstance(self.n_elements, list):
            self.indices = [
                [(ds, di)
                 for i, ds in enumerate(self.rng.sample(
                     range(self.n_datasets), k=len(self.n_elements)))
                 for di in self.rng.sample(range(n_data[ds]),
                                           k=self.n_elements[i])]
                for _ in range(self.curr_max_iters)]
        elif self.n_elements > self.n_datasets:
            raise ValueError(
                "'n_elements' should be no more than the dataset count")
        else:
            self.indices = [
                [(ds, self.rng.randrange(n_data[ds]))
                 for ds in self.rng.sample(range(self.n_datasets),
                                           k=self.n_elements)]
                for _ in range(self.curr_max_iters)]

    def __len__(self):
        return self.curr_max_iters

    def __getitem__(self, idx):
        sample = [self.datasets[ds][di] for ds, di in self.indices[idx]]
        if self.pair_based_transforms is not None:
            for transform, args in self.pair_based_transforms:
                sample = transform(sample, **args)
        return sample


def get_fgbg_masks(label: np.ndarray, class_id, class_ids) -> dict:
    """reference dev_customized_med.getMaskOnly (:24-46)."""
    fg = (label == class_id).astype(np.float32)
    bg = (label != class_id).astype(np.float32)
    for cid in class_ids:
        bg[label == cid] = 0
    return {"fg_mask": fg, "bg_mask": bg}


def fewshot_pairing(paired_sample, n_ways: int, n_shots: int,
                    cnt_query: list[int]) -> dict:
    """Assemble a support/query episode dict from a paired sample
    (reference dev_customized_med.py:51-153, mask_only path)."""
    cumsum = np.cumsum([0] + [n_shots + c for c in cnt_query])
    class_ids = [paired_sample[cumsum[i]].get("basic_class_id", 1)
                 for i in range(n_ways)]
    support_images = [[paired_sample[cumsum[i] + j]["image"]
                       for j in range(n_shots)] for i in range(n_ways)]
    support_labels = [[paired_sample[cumsum[i] + j]["label"]
                       for j in range(n_shots)] for i in range(n_ways)]
    support_mask = [
        [get_fgbg_masks(support_labels[i][j], class_ids[i], class_ids)
         for j in range(n_shots)] for i in range(n_ways)]

    query_images = []
    query_labels = []
    for i in range(n_ways):
        for j in range(cnt_query[i]):
            q = paired_sample[cumsum[i] + n_shots + j]
            query_images.append(q["image"])
            lab = np.full_like(q["label"], 255, dtype=np.float32)
            lab[q["label"] == class_ids[i]] = 1
            lab[q["label"] == 0] = 0
            query_labels.append(lab)

    return {"class_ids": class_ids,
            "support_images": support_images,
            "support_mask": support_mask,
            "query_images": query_images,
            "query_labels": query_labels}


def med_fewshot(dataset, n_ways: int = 1, n_shots: int = 1,
                n_queries: int = 1, max_iters_per_load: int = 1000,
                seed: int | None = None) -> ReloadPairedDataset:
    """Training episode stream over class subsets
    (reference dev_customized_med.med_fewshot :156-211)."""
    subsets = []
    for cls_name, idx_list in getattr(dataset, "idx_by_class",
                                      {"all": range(len(dataset))}).items():
        if len(idx_list):
            subsets.append(Subset(dataset, idx_list, class_id=cls_name))
    if not subsets:
        subsets = [Subset(dataset, range(len(dataset)), class_id=1)]
    cnt_query = [n_queries] * n_ways
    paired = ReloadPairedDataset(
        subsets, n_elements=[n_shots + nq for nq in cnt_query],
        curr_max_iters=max_iters_per_load,
        pair_based_transforms=[
            (lambda s, **kw: fewshot_pairing(s, **kw),
             dict(n_ways=n_ways, n_shots=n_shots, cnt_query=cnt_query))],
        seed=seed)
    return paired
