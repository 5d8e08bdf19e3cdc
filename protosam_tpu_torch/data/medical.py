"""Manually-annotated medical volume dataset + validation wrapper (JAX
``data/medical.py``).

Behavioral spec: reference dataloaders/ManualAnnoDatasetv2.py (ManualAnnoDataset)
and dataloaders/common.py:185-260 (ValidationDataset) — NIfTI volumes are
loaded eagerly, normalized per modality, resized, flattened into per-slice
records with scan/z bookkeeping; support slices are picked at fixed
percentile positions of the class's z-extent.

Arrays are numpy.  The volumes take JAX's numpy ingest path, with its
``cv2.resize`` done by ``F.interpolate`` on the CPU: bilinear
(``align_corners=False``) for images as ``INTER_LINEAR``, nearest for
labels as ``INTER_NEAREST``.  CLAHE and the native C++ feeder are not
ported (ROADMAP §1 items 21 and 22).
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from protosam_tpu_torch.data.dataset_registry import (DATASET_INFO,
                                                      CircularList,
                                                      get_normalize_op)
from protosam_tpu_torch.data.nifti import read_nii


def _resize_slices(vol: np.ndarray, size: int, mode: str) -> np.ndarray:
    """``cv2.resize(vol, (size, size), interpolation=INTER_LINEAR or
    INTER_NEAREST)`` of an (H, W, Z) float32 stack, slice by slice, on the
    CPU -> (size, size, Z)."""
    x = torch.from_numpy(np.ascontiguousarray(vol.transpose(2, 0, 1)))[None]
    if mode == "bilinear":
        y = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False)
    else:
        y = F.interpolate(x, size=(size, size), mode="nearest")
    return y[0].numpy().transpose(1, 2, 0)


@dataclass
class SliceRecord:
    img: np.ndarray      # (H, W, 1) normalized
    lb: np.ndarray       # (H, W, 1)
    is_start: bool
    is_end: bool
    nframe: int
    scan_id: str
    z_id: int


class MedicalVolumeDataset:
    """Eval-mode slice dataset over NIfTI volumes (ManualAnnoDataset with
    mode='val'; reference :27-259)."""

    def __init__(self, which_dataset: str, base_dir: str, idx_split: int,
                 image_size: int, min_fg: str = "1", tile_z_dim: int = 3,
                 nsup: int = 1, exclude_list: list | None = None,
                 use_clahe: bool = False, use_3_slices: bool = False,
                 extern_normalize_func: Callable | None = None):
        info = DATASET_INFO[which_dataset]
        self.img_modality = info["MODALITY"]
        self.sep = info["_SEP"]
        self.label_name = info["REAL_LABEL_NAME"]
        self.all_label_names = self.label_name
        self.nclass = len(self.label_name)
        self.image_size = image_size
        self.tile_z_dim = 1 if use_3_slices else tile_z_dim
        self.use_3_slices = use_3_slices
        self.base_dir = base_dir
        self.nsup = nsup
        self.min_fg = str(min_fg)
        self.exclude_lbs = exclude_list or []
        if use_clahe:
            raise NotImplementedError(
                "use_clahe needs CLAHE without cv2, not ported yet "
                "(ROADMAP §1 item 21)")

        pids = [re.findall(r"\d+", f)[-1]
                for f in glob.glob(f"{base_dir}/image_*.nii.gz")]
        self.img_pids = CircularList(sorted(pids, key=int))

        # validation fold: _SEP window + nsup wrap-around support candidates
        # (reference get_scanids :113-119)
        self.scan_ids = self.img_pids[self.sep[idx_split]:
                                      self.sep[idx_split + 1] + self.nsup]
        self.potential_support_sid = self.scan_ids[-self.nsup:]
        self.pid_curr_load = self.scan_ids

        if extern_normalize_func is not None:
            self.norm_func = extern_normalize_func
        else:
            vols = None
            if self.img_modality == "CT":
                vols = [read_nii(f"{base_dir}/image_{pid}.nii.gz")
                        for pid in self.scan_ids]
            self.norm_func = get_normalize_op(self.img_modality, vols)

        self.actual_dataset: list[SliceRecord] = []
        self.scan_z_idx: dict[str, list[int]] = {}
        self.info_by_scan: dict[str, Any] = {}
        self._read_dataset()
        self.overall_slice_by_cls = self._read_classfiles()
        self._update_subclass_lookup()

    # -- loading -----------------------------------------------------------

    def _read_dataset(self):
        glb_idx = 0
        for scan_id in self.pid_curr_load:
            img_meta = read_nii(f"{self.base_dir}/image_{scan_id}.nii.gz",
                                peel_info=False)
            self.info_by_scan[scan_id] = img_meta
            img = img_meta.array.transpose(1, 2, 0)  # (H, W, Z)
            img = self.norm_func(np.float32(img))

            lb = read_nii(f"{self.base_dir}/label_{scan_id}.nii.gz")
            lb = np.float32(lb.transpose(1, 2, 0))

            img = _resize_slices(np.float32(img), self.image_size,
                                 "bilinear")
            lb = _resize_slices(lb, self.image_size, "nearest")
            nframe = img.shape[-1]
            self.scan_z_idx[scan_id] = [-1] * nframe
            for ii in range(nframe):
                self.actual_dataset.append(SliceRecord(
                    img=img[..., ii:ii + 1], lb=lb[..., ii:ii + 1],
                    is_start=(ii == 0), is_end=(ii == nframe - 1),
                    nframe=nframe if ii == 0 else -1,
                    scan_id=scan_id, z_id=ii))
                self.scan_z_idx[scan_id][ii] = glb_idx
                glb_idx += 1
        self.size = len(self.actual_dataset)

    def _read_classfiles(self):
        with open(os.path.join(self.base_dir,
                               f"classmap_{self.min_fg}.json")) as f:
            cls_map = json.load(f)
        with open(os.path.join(self.base_dir, "classmap_1.json")) as f:
            self.tp1_cls_map = json.load(f)
        return cls_map

    def _update_subclass_lookup(self):
        self.idx_by_class: dict[str, list[int]] = {c: [] for c in self.label_name}
        for cls, by_pid in self.overall_slice_by_cls.items():
            for pid, slices in by_pid.items():
                if pid not in self.pid_curr_load:
                    continue
                self.idx_by_class[cls] += [self.scan_z_idx[pid][s]
                                           for s in slices]

    # -- item access -------------------------------------------------------

    def __len__(self):
        return len(self.actual_dataset)

    def _assemble_image(self, rec: SliceRecord, index: int) -> np.ndarray:
        img = np.float32(rec.img)
        if self.use_3_slices:
            prev_img = np.zeros_like(img)
            if index > 0 and not rec.is_start:
                prev_img = self.actual_dataset[index - 1].img
            next_img = np.zeros_like(img)
            if index < len(self.actual_dataset) - 1 and not rec.is_end:
                next_img = self.actual_dataset[index + 1].img
            img = np.concatenate([prev_img, img, next_img], axis=-1)
        img = np.transpose(img, (2, 0, 1))          # (1 or 3, H, W)
        if self.tile_z_dim > 1:
            img = np.tile(img, (self.tile_z_dim, 1, 1))
        return img

    def __getitem__(self, index: int) -> dict:
        rec = self.actual_dataset[index % self.size]
        img = self._assemble_image(rec, index % self.size)
        lb = np.float32(rec.lb)[..., 0]
        return {"image": img, "label": lb, "is_start": rec.is_start,
                "is_end": rec.is_end, "nframe": np.int32(rec.nframe),
                "scan_id": rec.scan_id, "z_id": rec.z_id}

    # -- support selection (reference get_support :439-545) ----------------

    def get_support(self, curr_class: int, class_idx: list, scan_idx: list,
                    npart: int) -> dict:
        assert npart % 2 == 1
        assert curr_class != 0 and 0 not in class_idx
        self.potential_support_sid = [self.pid_curr_load[i] for i in scan_idx]

        if npart == 1:
            pcts = [0.5]
        else:
            half = 1 / (npart * 2)
            interval = (1.0 - 1.0 / npart) / (npart - 1)
            pcts = [half + interval * i for i in range(npart)]

        support_images, support_mask, support_class = [], [], []
        for pct in pcts:
            imgs, lbs = [], []
            for order in scan_idx:
                sid = self.pid_curr_load[order]
                zlist = self.tp1_cls_map[self.label_name[curr_class]][sid]
                zid = zlist[int(pct * len(zlist))]
                gi = self.scan_z_idx[sid][zid]
                rec = self.actual_dataset[gi]
                imgs.append(self._assemble_image(rec, gi))
                lbs.append(np.float32(rec.lb)[..., 0])
            img = np.stack(imgs, axis=0)            # (nsup, C, H, W)
            lb = np.stack(lbs, axis=0)
            support_images.append(img)
            support_class.append(curr_class)
            support_mask.append(self.get_fgbg_masks(lb, curr_class, class_idx))
        return {"class_ids": [support_class],
                "support_images": [support_images],
                "support_mask": [support_mask]}

    @staticmethod
    def get_fgbg_masks(label: np.ndarray, class_id: int,
                       class_ids: list) -> dict:
        """reference getMaskMedImg (:405-420)."""
        fg = (label == class_id).astype(np.float32)
        bg = (label != class_id).astype(np.float32)
        for cid in class_ids:
            bg[label == cid] = 0
        return {"fg_mask": fg, "bg_mask": bg}

    def get_support_scan(self, curr_class: int, class_idx: list,
                         scan_idx: list) -> dict:
        """Whole-volume support (reference get_support_scan :547-570):
        every slice of the chosen scan as one multi-shot support stack."""
        self.potential_support_sid = [self.pid_curr_load[i] for i in scan_idx]
        sid = self.potential_support_sid[0]
        imgs, lbs = [], []
        for gi in self.scan_z_idx[sid]:
            rec = self.actual_dataset[gi]
            imgs.append(self._assemble_image(rec, gi))
            lbs.append(np.float32(rec.lb)[..., 0])
        img = np.stack(imgs, axis=0)
        lb = np.stack(lbs, axis=0)
        return {"class_ids": [[curr_class]],
                "support_images": [[img]],
                "support_mask": [[self.get_fgbg_masks(lb, curr_class,
                                                      class_idx)]]}

    def get_support_multiple_classes(self, class_idx: list, scan_idx: list,
                                     npart: int) -> dict:
        """Per-class chunked supports (reference
        get_support_multiple_classes :573-695)."""
        out = {"class_ids": [], "support_images": [], "support_mask": []}
        for cls in class_idx:
            sup = self.get_support(cls, class_idx, scan_idx, npart)
            out["class_ids"] += sup["class_ids"]
            out["support_images"] += sup["support_images"]
            out["support_mask"] += sup["support_mask"]
        return out

    def get_scan(self, index: int) -> dict:
        """MODE_FULL_SCAN item (reference __get_ct_scan___ :249-277): the
        whole (Z, H, W) stack of one scan."""
        scan_id = list(self.scan_z_idx)[index % len(self.scan_z_idx)]
        idxs = self.scan_z_idx[scan_id]
        imgs = np.concatenate([self.actual_dataset[i].img for i in idxs],
                              axis=-1).transpose(2, 0, 1)
        lbs = np.concatenate([self.actual_dataset[i].lb for i in idxs],
                             axis=-1).transpose(2, 0, 1)
        img = np.float32(imgs)[None]
        if self.tile_z_dim > 1:
            img = np.repeat(img, self.tile_z_dim, axis=0)  # (C, Z, H, W)
        return {"image": img, "label": np.float32(lbs), "scan_id": scan_id}


class ValidationDataset:
    """Current-class label stripping + z-chunk assignment
    (reference common.py:185-260)."""

    def __init__(self, dataset: MedicalVolumeDataset, test_classes: list,
                 npart: int):
        self.dataset = dataset
        self.test_classes = test_classes
        self.npart = npart
        self._curr_cls: int | None = None

    def set_curr_cls(self, curr_cls: int):
        assert curr_cls in self.test_classes
        self._curr_cls = curr_cls

    def get_curr_cls(self):
        return self._curr_cls

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        if self._curr_cls is None:
            raise RuntimeError("Please initialize current class first")
        sample = self.dataset[idx]
        sample["label"] = (sample["label"] == self._curr_cls).astype(np.float32)
        labelname = self.dataset.all_label_names[self._curr_cls]
        zlist = self.dataset.tp1_cls_map[labelname][sample["scan_id"]]
        z_min, z_max = min(zlist), max(zlist)
        sample["z_min"], sample["z_max"] = z_min, z_max
        try:
            part = int((sample["z_id"] - z_min) // ((z_max - z_min) / self.npart))
        except ZeroDivisionError:
            part = 0
        sample["part_assign"] = min(max(part, 0), self.npart - 1)
        sample["case"] = sample["scan_id"]
        return sample

    def get_support_set(self, config: dict, n_support: int = 3) -> dict:
        batched = self.dataset.get_support(
            curr_class=self._curr_cls, class_idx=[self._curr_cls],
            scan_idx=config["support_idx"], npart=config["task"]["npart"])
        return {
            "support_images": [img for way in batched["support_images"]
                               for img in way],
            "support_labels": [m["fg_mask"] for way in batched["support_mask"]
                               for m in way],
            "support_scan_id": self.dataset.potential_support_sid,
        }


def med_fewshot_val(dataset_name: str, base_dir: str, idx_split: int,
                    act_labels: list, npart: int, image_size: int = 672,
                    nsup: int = 1, **kwargs):
    """(ValidationDataset, MedicalVolumeDataset) — reference
    dev_customized_med.med_fewshot_val (:224-249)."""
    parent = MedicalVolumeDataset(
        which_dataset=dataset_name, base_dir=base_dir, idx_split=idx_split,
        image_size=image_size, min_fg="1", nsup=nsup, **kwargs)
    return ValidationDataset(parent, test_classes=act_labels,
                             npart=npart), parent
