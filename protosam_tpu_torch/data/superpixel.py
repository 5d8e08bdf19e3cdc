"""Self-supervised superpixel episodic training dataset (JAX
``data/superpixel.py``; reference dataloaders/GenericSuperDatasetv2.py).

Each item picks a random superpixel id of the slice's precomputed
superpixel map as a pseudo-label and makes a (support, query) pair by
sending the same slice twice through independent draws of the geometric
+ intensity augmentation (``num_rep=2``).  The supervised variant uses the
real labels restricted to ``train_list``.  Volumes resize through the
data layer's cv2-free resize (``data/medical._resize_slices``: cv2's
bilinear for images and nearest for labels, bit for bit).  ``use_clahe`` applies CLAHE (clip 4.0 for MR,
2.0 for CT, 7 x 7 tiles; ``data/clahe.py``, cv2's bits) to each raw slice
cast to uint8 by numpy, an MR slice first stretched to 0-255, as JAX does.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np

from protosam_tpu_torch.data.clahe import clahe
from protosam_tpu_torch.data.dataset_registry import (DATASET_INFO,
                                                      CircularList,
                                                      get_normalize_op)
from protosam_tpu_torch.data.medical import _resize_slices
from protosam_tpu_torch.data.nifti import read_nii


class SuperpixelDataset:
    def __init__(self, which_dataset: str, base_dir: str, idx_split: int,
                 mode: str, image_size: int, transforms, num_rep: int = 2,
                 nsup: int = 1, fix_length: int | None = None,
                 tile_z_dim: int = 3, exclude_list: list | None = None,
                 train_list: list | None = None,
                 superpix_scale: str = "MIDDLE", norm_mean=None,
                 norm_std=None, supervised_train: bool = False,
                 use_3_slices: bool = False, use_clahe: bool = False,
                 seed: int | None = None, **kwargs):
        info = DATASET_INFO[which_dataset]
        self.img_modality = info["MODALITY"]
        self.sep = info["_SEP"]
        self.pseu_label_name = info["PSEU_LABEL_NAME"]
        self.real_label_name = info["REAL_LABEL_NAME"]
        self.image_size = image_size
        self.transforms = transforms
        self.is_train = mode == "train"
        self.supervised_train = supervised_train
        self.train_list = train_list or []
        if supervised_train and not self.train_list:
            raise ValueError("Please provide training labels")
        self.fix_length = fix_length
        self.nclass = len(self.pseu_label_name)
        self.num_rep = num_rep
        self.tile_z_dim = 1 if use_3_slices else tile_z_dim
        self.use_3_slices = use_3_slices
        self.base_dir = base_dir
        self.nsup = nsup
        self.exclude_lbs = exclude_list or []
        self.superpix_scale = superpix_scale
        self.rng = np.random.RandomState(seed)
        self.use_clahe = use_clahe
        self.clahe_clip = 4.0 if self.img_modality == "MR" else 2.0

        pids = [re.findall(r"\d+", f)[-1]
                for f in glob.glob(f"{base_dir}/image_*.nii.gz")]
        self.img_pids = CircularList(sorted(pids, key=int))
        val_ids = self.img_pids[self.sep[idx_split]:
                                self.sep[idx_split + 1] + self.nsup]
        self.scan_ids = ([p for p in self.img_pids if p not in val_ids]
                         if mode == "train" else val_ids)
        self.pid_curr_load = self.scan_ids

        vols = None
        if self.img_modality == "CT" and norm_mean is None:
            vols = [read_nii(f"{base_dir}/image_{p}.nii.gz")
                    for p in self.scan_ids]
        self.norm_func = get_normalize_op(self.img_modality, vols,
                                          ct_mean=norm_mean, ct_std=norm_std)

        self.actual_dataset = self._read_dataset()
        self.size = len(self.actual_dataset)
        self.overall_slice_by_cls = self._read_classfiles()

    def _label_path(self, scan_id: str) -> str:
        if self.supervised_train:
            return f"{self.base_dir}/label_{scan_id}.nii.gz"
        return f"{self.base_dir}/superpix-{self.superpix_scale}_{scan_id}.nii.gz"

    def _read_dataset(self):
        out = []
        self.scan_z_idx = {}
        glb = 0
        for scan_id in self.pid_curr_load:
            img = read_nii(f"{self.base_dir}/image_{scan_id}.nii.gz")
            if self.use_clahe:
                if self.img_modality == "MR":
                    img = np.stack([(s - s.min()) / (s.max() - s.min()) * 255
                                    for s in img], axis=0)
                img = clahe(img.astype(np.uint8), self.clahe_clip)
            img = self.norm_func(np.float32(img.transpose(1, 2, 0)))
            lb = np.int32(read_nii(self._label_path(scan_id)).transpose(1, 2, 0))
            img = _resize_slices(np.float32(img), self.image_size, "bilinear")
            lb = np.int32(_resize_slices(np.float32(lb), self.image_size,
                                         "nearest"))

            if self.supervised_train:
                keep = [i for i in range(img.shape[-1])
                        if np.any(np.isin(lb[..., i], self.train_list))]
                img, lb = img[..., keep], lb[..., keep]

            nframe = img.shape[-1]
            self.scan_z_idx[scan_id] = [-1] * nframe
            for ii in range(nframe):
                out.append({"img": img[..., ii:ii + 1],
                            "lb": lb[..., ii:ii + 1],
                            "sup_max_cls": lb[..., ii:ii + 1].max(),
                            "is_start": ii == 0,
                            "is_end": ii == nframe - 1,
                            "nframe": nframe, "scan_id": scan_id, "z_id": ii})
                self.scan_z_idx[scan_id][ii] = glb
                glb += 1
        return out

    def _read_classfiles(self):
        with open(os.path.join(self.base_dir, "classmap_1.json")) as f:
            self.tp1_cls_map = json.load(f)
        return self.tp1_cls_map

    def __len__(self):
        if self.fix_length is not None:
            assert self.fix_length >= len(self.actual_dataset)
            return self.fix_length
        return len(self.actual_dataset)

    def _adjacent_image(self, image, index, rec):
        prev_img = np.zeros_like(image)
        if index > 0 and not rec["is_start"]:
            prev_img = self.actual_dataset[index - 1]["img"]
        next_img = np.zeros_like(image)
        if index < len(self.actual_dataset) - 1 and not rec["is_end"]:
            next_img = self.actual_dataset[index + 1]["img"]
        return np.concatenate([prev_img, image, next_img], axis=-1)

    def __getitem__(self, index: int) -> dict:
        index = index % len(self.actual_dataset)
        rec = self.actual_dataset[index]
        if rec["sup_max_cls"] < 1:
            return self[index + 1]

        image_t = rec["img"]
        label_raw = rec["lb"]
        if self.use_3_slices:
            image_t = self._adjacent_image(image_t, index, rec)

        for ex in self.exclude_lbs:
            zmap = self.tp1_cls_map[self.real_label_name[ex]]
            if rec["z_id"] in zmap.get(rec["scan_id"], []):
                return self[int(self.rng.randint(0, len(self) - 1))]

        if self.supervised_train:
            superpix_label = -1
            choices = sorted(set(np.unique(label_raw)) & set(self.train_list))
            lb_id = choices[self.rng.randint(len(choices))]
            label_t = np.float32(label_raw == lb_id)
        else:
            ids = np.unique(label_raw)
            superpix_label = ids[self.rng.randint(len(ids))]
            label_t = np.float32(label_raw == superpix_label)

        comp = np.concatenate([image_t, label_t], axis=-1)
        pair = []
        for _ in range(self.num_rep):
            if self.transforms is not None:
                img, lb = self.transforms(comp, c_img=image_t.shape[-1],
                                          c_label=1, nclass=self.nclass,
                                          is_train=True, use_onehot=False)
            else:
                img, lb = comp[..., :image_t.shape[-1]], comp[..., -1:]
            img = np.transpose(np.float32(img), (2, 0, 1))
            lb = np.float32(lb)[..., 0]
            if self.tile_z_dim > 1:
                img = np.tile(img, (self.tile_z_dim, 1, 1))
            pair.append({"image": img, "label": lb})

        support, query = pair[0], pair[1]
        fg = np.float32(support["label"] == 1)
        bg = np.float32(support["label"] != 1)
        return {
            "class_ids": [[1]],
            "support_images": [[support["image"]]],
            "superpix_label": superpix_label,
            "support_mask": [[{"fg_mask": fg, "bg_mask": bg}]],
            "query_images": [query["image"]],
            "query_labels": [query["label"]],
            "scan_id": rec["scan_id"],
            "z_id": rec["z_id"],
            "nframe": rec["nframe"],
        }
