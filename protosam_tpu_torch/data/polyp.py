"""Polyp (2D RGB endoscopy) datasets (JAX ``data/polyp.py``; reference
dataloaders/PolypDataset.py).

Kvasir/CVC/ETIS-style layout: ``<root>/<dataset>/{images,masks}`` with a
``split.txt`` (train:/val:/test: sections).  Queries come from the test
split; supports are drawn from the train split, from directories, or from
a txt list (reference :228-316), with ``random.Random(seed)`` as JAX draws
them.  Preprocessing: per-dataset mean/std normalisation + bilinear resize,
or the SAM longest-side transform with pad (``use_sam_trans``, reference
:319-348).

Without cv2: PNGs are read by ``data/png.py`` (``cv2.imread``'s pixels),
the resizes are ``data/prepare.resize_linear`` / ``resize_nearest``
(``cv2.resize``'s bits), the superpixels the native Felzenszwalb
(``data/prepare.felzenszwalb``).
"""

from __future__ import annotations

import os
import random

import numpy as np

from protosam_tpu_torch.data.png import read_png
from protosam_tpu_torch.data.prepare import (felzenszwalb, resize_linear,
                                             resize_nearest)
from protosam_tpu_torch.ops.resize import longest_side_size

DATASETS = ("Kvasir", "CVC-ClinicDB", "CVC-ColonDB", "CVC-300", "ETIS")


def _load(path: str, is_mask: bool) -> np.ndarray:
    """A mask as {0, 1} float32 (grey > 127), an image as RGB float32."""
    if is_mask:
        return (read_png(path, grayscale=True) > 127).astype(np.float32)
    return read_png(path).astype(np.float32)


def _read_split(text_file: str, split: str) -> list[str]:
    splits: dict[str, list[str]] = {"train": [], "val": [], "test": []}
    cur = None
    with open(text_file) as f:
        for line in f:
            line = line.strip()
            if line.rstrip(":") in splits:
                cur = line.rstrip(":")
            elif line and cur:
                splits[cur].append(line)
    return splits[split]


def _case(path: str) -> str:
    return os.path.basename(os.path.dirname(os.path.dirname(path)))


class PolypDataset:
    def __init__(self, root: str, trainsize: int = 352, train: bool = True,
                 use_sam_trans: bool = True, image_size=(1024, 1024),
                 datasets=DATASETS, ds_mean=None, ds_std=None,
                 seed: int | None = None):
        self.root = root
        self.image_size = (image_size, image_size) \
            if isinstance(image_size, int) else tuple(image_size)
        self.train = train
        self.use_sam_trans = use_sam_trans
        self.rng = random.Random(seed)

        self.images: list[str] = []
        self.gts: list[str] = []
        split = "train" if train else "test"
        for folder in sorted(os.listdir(root)):
            if folder not in datasets:
                continue
            split_file = os.path.join(root, folder, "split.txt")
            if not os.path.isfile(split_file):
                continue
            for name in _read_split(split_file, split):
                self.images.append(os.path.join(root, folder, "images",
                                                name + ".png"))
                self.gts.append(os.path.join(root, folder, "masks",
                                             name + ".png"))
        self.images.sort()
        self.gts.sort()
        self.size = len(self.images)

        if ds_mean is not None:
            self.mean, self.std = ds_mean, ds_std
        elif self.size and not use_sam_trans:
            sample = _load(self.images[0], is_mask=False)
            self.mean, self.std = float(sample.mean()), float(sample.std())
        else:
            self.mean, self.std = 0.0, 1.0

    def __len__(self):
        return self.size

    def process_image_gt(self, image: np.ndarray, gt: np.ndarray,
                         case: str = "") -> dict:
        """(H, W, 3) float image + (H, W) mask -> CHW arrays in the model
        frame (reference process_image_gt :319-348)."""
        original_size = image.shape[:2]
        img = image.transpose(2, 0, 1)
        if self.use_sam_trans:
            tgt = max(self.image_size)
            nh, nw = longest_side_size(*original_size, tgt)
            img = resize_linear(image, (nw, nh),
                                channels_last=True).transpose(2, 0, 1)
            m = resize_linear(gt, (nw, nh))
            img = np.pad(img, ((0, 0), (0, tgt - nh), (0, tgt - nw)))
            m = np.pad(m, ((0, tgt - nh), (0, tgt - nw)))
        else:
            img = (img - self.mean) / self.std
            img = resize_linear(img.transpose(1, 2, 0), self.image_size[::-1],
                                channels_last=True).transpose(2, 0, 1)
            m = resize_nearest(gt, self.image_size[::-1])
        m = (m > 0.5).astype(np.float32)
        return {"image": img.astype(np.float32), "label": m,
                "original_size": original_size, "case": case}

    def __getitem__(self, index: int) -> dict:
        img = _load(self.images[index], is_mask=False)
        gt = _load(self.gts[index], is_mask=True)
        return self.process_image_gt(img, gt, _case(self.images[index]))

    def get_support(self, n_support: int = 1, support_image_dir=None,
                    support_mask_dir=None, text_file=None):
        """(support_images [n x (1, C, H, W)], support_labels, case) —
        reference get_support :291-316.  Directories list ``.jpg`` and
        ``.png`` images as JAX does; a ``.jpg`` raises when it is read."""
        if support_image_dir and support_mask_dir:
            imgs = sorted(os.path.join(support_image_dir, f)
                          for f in os.listdir(support_image_dir)
                          if f.endswith((".jpg", ".png")))
            gts = sorted(os.path.join(support_mask_dir, f)
                         for f in os.listdir(support_mask_dir)
                         if f.endswith(".png"))
            pairs = [(imgs[i], gts[i]) for i in
                     (self.rng.randrange(len(imgs))
                      for _ in range(n_support))]
        elif text_file:
            with open(text_file) as f:
                rows = [line.strip().split() for line in f if line.strip()]
            if n_support > len(rows):
                raise ValueError("n_support larger than support list")
            pairs = [tuple(r) for r in rows[:n_support]]
        else:
            idxs = [self.rng.randrange(self.size) for _ in range(n_support)]
            pairs = [(self.images[i], self.gts[i]) for i in idxs]

        sup_imgs, sup_gts, case = [], [], ""
        for ip, gp in pairs:
            out = self.process_image_gt(_load(ip, False), _load(gp, True),
                                        _case(ip))
            sup_imgs.append(out["image"][None])
            sup_gts.append(out["label"][None])
            case = out["case"]
        return sup_imgs, sup_gts, case


class SuperpixPolypDataset(PolypDataset):
    """SSL episodic variant (reference PolypDataset.py:419-505): a random
    superpixel of the query image becomes the pseudo-label, and two
    augmentation draws of the same image form the (support, query) pair.
    Superpixels come from the native Felzenszwalb (the reference
    precomputes them with skimage)."""

    def __init__(self, *args, num_rep: int = 2, transforms=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_rep = num_rep
        self.transforms = transforms

    def __getitem__(self, index: int) -> dict:
        img = _load(self.images[index], is_mask=False)
        gray = img.mean(axis=-1).astype(np.float32)
        seg = felzenszwalb(gray, scale=100.0, sigma=1.0, min_size=400)
        ids = np.unique(seg)
        ids = ids[ids > 0] if (ids > 0).any() else ids
        pick = ids[self.rng.randrange(len(ids))]
        pseudo = (seg == pick).astype(np.float32)

        pair = []
        for _ in range(self.num_rep):
            im, m = (self.transforms(img, pseudo) if self.transforms
                     else (img, pseudo))
            pair.append(self.process_image_gt(im, m))
        support, query = pair[0], pair[1]
        fg = support["label"]
        return {
            "class_ids": [[1]],
            "support_images": [[support["image"]]],
            "support_mask": [[{"fg_mask": fg, "bg_mask": 1.0 - fg}]],
            "query_images": [query["image"]],
            "query_labels": [query["label"]],
            "superpix_label": int(pick),
        }
