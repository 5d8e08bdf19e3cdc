"""Manually-annotated medical volume dataset + validation wrapper (JAX
``data/medical.py``).

Behavioral spec: reference dataloaders/ManualAnnoDatasetv2.py (ManualAnnoDataset)
and dataloaders/common.py:185-260 (ValidationDataset) — NIfTI volumes are
loaded eagerly, normalized per modality, resized, flattened into per-slice
records with scan/z bookkeeping; support slices are picked at fixed
percentile positions of the class's z-extent.

Arrays are numpy.  The volumes take one of JAX's two ingest paths,
chosen once a dataset as JAX chooses: MR without CLAHE goes through the
native C++ feeder (``native/feeder.py``: read, bilinear resize and z-score
in one pass, bit-equal to JAX's), where g++ is installed; otherwise JAX's
numpy path, with its ``cv2.resize`` reproduced bit for bit in numpy
(``data/prepare.resize_linear`` for images as ``INTER_LINEAR``,
``resize_nearest`` for labels as ``INTER_NEAREST``).  Labels take the nearest resize on both
paths.  ``use_clahe`` applies CLAHE (clip 2.0, 7 x 7 tiles;
``data/clahe.py``, cv2's bits) to each raw slice cast to uint8 by numpy, as
JAX does.

The fold loads as one task a scan, each on a thread of a pool of
min(scans, the CPUs this process may use) (a one-scan fold inline): the
image's decode, its preprocess, the label's decode and its resize.  Each
file is decompressed once: on the native path the image's metadata
(``info_by_scan``: spacing, origin, direction, no voxels) comes from the
bytes the feeder inflated, and CT's normalisation, which takes every
image first, hands each decoded image on to its scan's task.  zlib,
numpy and the native library release the interpreter, so the scans
overlap.  The slice records are built here after the tasks, in scan
order, so the dataset is the serial load's.

Loading is traced (``utils/profiling.py``) per scan: ``data.decode`` (a
file's bytes to voxels), ``data.preprocess`` (resize + normalize),
``data.labels`` (the labels' resize), each under the span open where the
load began, and ``data.index`` (the slice records; once more for the
class files); ``read_nii`` and the feeder count ``bytes_read``
(compressed), ``bytes_decoded`` and ``files``, which reach the spans open
around the load once its tasks are back.  ``load_workers`` is the pool's
size.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np

from protosam_tpu_torch import native
from protosam_tpu_torch.data.clahe import clahe
from protosam_tpu_torch.data.dataset_registry import (DATASET_INFO,
                                                      CircularList,
                                                      get_normalize_op)
from protosam_tpu_torch.data.nifti import read_nii
from protosam_tpu_torch.data.prepare import resize_linear, resize_nearest
from protosam_tpu_torch.utils import profiling


def _resize_slices(vol: np.ndarray, size: int, mode: str) -> np.ndarray:
    """``cv2.resize(vol, (size, size), interpolation=INTER_LINEAR or
    INTER_NEAREST)`` of an (H, W, Z) float32 stack, which cv2 takes as one
    image of Z channels, bit for bit (``data/prepare.resize_linear`` /
    ``resize_nearest``) -> (size, size, Z)."""
    if mode == "bilinear":
        return resize_linear(vol, size, channels_last=True)
    return resize_nearest(vol, size, channels_last=True)


@dataclasses.dataclass
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
        self.use_clahe = use_clahe

        pids = [re.findall(r"\d+", f)[-1]
                for f in glob.glob(f"{base_dir}/image_*.nii.gz")]
        self.img_pids = CircularList(sorted(pids, key=int))

        # validation fold: _SEP window + nsup wrap-around support candidates
        # (reference get_scanids :113-119)
        self.scan_ids = self.img_pids[self.sep[idx_split]:
                                      self.sep[idx_split + 1] + self.nsup]
        self.potential_support_sid = self.scan_ids[-self.nsup:]
        self.pid_curr_load = self.scan_ids

        # CT's statistics take every image: ``_read_dataset`` sets them
        self.norm_func = extern_normalize_func
        if self.norm_func is None and self.img_modality == "MR":
            self.norm_func = get_normalize_op("MR")

        self.actual_dataset: list[SliceRecord] = []
        self.scan_z_idx: dict[str, list[int]] = {}
        self.info_by_scan: dict[str, Any] = {}
        self._read_dataset()
        with profiling.span("data.index"):
            self.overall_slice_by_cls = self._read_classfiles()
            self._update_subclass_lookup()

    # -- loading -----------------------------------------------------------

    def _read_dataset(self):
        use_native = (self.img_modality == "MR" and not self.use_clahe
                      and native.native_available())
        scans = list(self.pid_curr_load)
        parent = profiling.current()
        self.load_workers = min(len(scans), len(os.sched_getaffinity(0)))
        images = [None] * len(scans)
        if self.norm_func is None:
            images = self._in_parallel(
                lambda sid: self._decode_image(sid, parent), scans)
            self.norm_func = get_normalize_op(
                self.img_modality, [im.array for im in images])
        loaded = self._in_parallel(
            lambda item: self._load_scan(*item, use_native, parent),
            list(zip(scans, images)))
        glb_idx = 0
        for scan_id, (info, img, lb) in zip(scans, loaded):
            self.info_by_scan[scan_id] = info
            with profiling.span("data.index", scan=scan_id):
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

    def _in_parallel(self, fn, items: list) -> list:
        """``[fn(item) for item in items]``, one task an item on
        ``load_workers`` threads (inline for one).  The counts the tasks
        make on their threads are added to the spans open here once they
        are all back."""
        if self.load_workers <= 1:
            return [fn(item) for item in items]

        def task(item):
            with profiling.tally() as counts:
                return fn(item), counts

        with ThreadPoolExecutor(self.load_workers) as pool:
            done = list(pool.map(task, items))
        for _, counts in done:
            for key, n in counts.items():
                profiling.count(key, n)
        return [out for out, _ in done]

    def _decode_image(self, scan_id: str, parent):
        with profiling.span("data.decode", parent=parent, scan=scan_id):
            return read_nii(f"{self.base_dir}/image_{scan_id}.nii.gz",
                            peel_info=False)

    def _load_scan(self, scan_id: str, image, use_native: bool, parent):
        """One scan -> (its metadata without voxels, the image stack
        (H, W, Z) normalized, the label stack (H, W, Z)); ``image`` is its
        decoded image where the caller has it."""
        label_path = f"{self.base_dir}/label_{scan_id}.nii.gz"
        if use_native:
            # C++ single-pass read+resize+normalize (hot ingest path)
            vol, _, info = native.read_volume_native(
                f"{self.base_dir}/image_{scan_id}.nii.gz", info=True,
                parent=parent)
            with profiling.span("data.preprocess", parent=parent,
                                scan=scan_id):
                img = native.preprocess_volume_native(
                    vol, self.image_size, "MR").transpose(1, 2, 0)
            lbv, _ = native.read_volume_native(label_path, parent=parent)
            with profiling.span("data.labels", parent=parent, scan=scan_id):
                lb = _resize_slices(lbv.transpose(1, 2, 0), self.image_size,
                                    "nearest")
            return info, img, lb
        if image is None:
            image = self._decode_image(scan_id, parent)
        with profiling.span("data.preprocess", parent=parent, scan=scan_id):
            img = image.array
            if self.use_clahe:
                img = clahe(img.astype(np.uint8), 2.0)
            img = self.norm_func(np.float32(img.transpose(1, 2, 0)))
            img = _resize_slices(np.float32(img), self.image_size,
                                 "bilinear")
        with profiling.span("data.decode", parent=parent, scan=scan_id):
            lb = read_nii(label_path)
        with profiling.span("data.labels", parent=parent, scan=scan_id):
            lb = _resize_slices(np.float32(lb.transpose(1, 2, 0)),
                                self.image_size, "nearest")
        return dataclasses.replace(image, array=None), img, lb

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
