"""Automatic mask generation (reference segment_anything/
automatic_mask_generator.py + utils/amg.py; JAX ``models/sam/amg.py``).

A point grid is decoded batched through the mask decoder (multimask),
filtered by predicted IoU and stability score and deduplicated with box
NMS.  ``crop_n_layers > 0`` also sweeps zoomed-in crops (each re-encoded,
reference automatic_mask_generator.py:216-229) with per-layer downscaled
grids and deduplicates across crops preferring smaller crops;
``min_mask_region_area`` removes small holes and islands from each mask
through the CCA of ``ops/cca.py`` (kernel K3 on the card; the reference
uses cv2); ``output_mode`` is binary_mask, uncompressed_rle or coco_rle.

The masks stay on the model's device until the records are written; the
per-record numbers (IoU, stability, boxes, points) follow JAX's numpy
arithmetic on the host, so the kept sets are JAX's.  Box NMS computes its
f32 IoU matrix where the boxes are and runs the greedy pass on the host
after one copy.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Any

import numpy as np
import torch

from protosam_tpu_torch.models.sam.rle import coco_encode_rle, mask_to_rle
from protosam_tpu_torch.models.sam.sam import encode_image_array
from protosam_tpu_torch.ops.cca import label_components
from protosam_tpu_torch.ops.resize import longest_side_size, resize_bilinear


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced [0, 1]² grid, (N, 2) xy (reference
    utils/amg.py:179-187)."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> list[np.ndarray]:
    """Per-crop-layer grids (reference utils/amg.py:190-198)."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: tuple[int, int], n_layers: int,
                        overlap_ratio: float
                        ) -> tuple[list[list[int]], list[int]]:
    """XYXY crop boxes per layer: layer i has (2^i)² overlapping crops
    (reference utils/amg.py:200-233)."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes, layer_idxs = [[0, 0, im_w, im_h]], [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                               min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def remove_small_regions(mask, area_thresh: float, mode: str,
                         device: torch.device | str = "cuda"):
    """Remove small disconnected regions (``mode='islands'``) or fill small
    holes (``'holes'``) of an (H, W) mask (reference utils/amg.py:267-292,
    cv2's connected components replaced by ``label_components``).  Returns
    (mask, changed).  A tensor is worked on where it lives; a numpy mask
    on ``device`` (the card unless the caller asks for the CPU) and comes
    back as numpy."""
    if not isinstance(mask, torch.Tensor):
        out, changed = remove_small_regions(
            torch.as_tensor(np.asarray(mask, bool), device=device),
            area_thresh, mode)
        return out.cpu().numpy(), changed
    correct_holes = mode == "holes"
    working = mask.bool() ^ correct_holes
    if not bool(working.any()):
        return mask, False
    lab = label_components(working[None])[0]
    ids, counts = torch.unique(lab[working], return_counts=True)
    small = ids[counts < area_thresh]
    if small.numel() == 0:
        return mask, False
    if correct_holes:
        return mask.bool() | (torch.isin(lab, small) & working), True
    keep = ids[counts >= area_thresh]
    if keep.numel() == 0:  # every region small: keep the largest
        keep = ids[torch.argmax(counts)][None]
    return torch.isin(lab, keep) & working, True


def stability_score(mask_logits: torch.Tensor, mask_threshold: float,
                    offset: float) -> torch.Tensor:
    """IoU between the masks thresholded at ±offset, an f32 quotient of the
    two pixel counts (reference utils/amg.py:156-176)."""
    high = (mask_logits > mask_threshold + offset).sum(dim=(-1, -2))
    low = (mask_logits > mask_threshold - offset).sum(dim=(-1, -2))
    return high.float() / low.clamp(min=1).float()


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """XYXY box of each binary (..., H, W) mask, zeros for an empty one
    (reference batched_mask_to_box, utils/amg.py:303-346); int64."""
    h, w = mask.shape[-2:]
    ys = torch.arange(h, device=mask.device)[:, None]
    xs = torch.arange(w, device=mask.device)[None, :]
    big = 1 << 30
    mask = mask.bool()
    any_fg = mask.any(dim=-1).any(dim=-1)
    min_x = torch.where(mask, xs, big).amin(dim=(-1, -2))
    max_x = torch.where(mask, xs, -1).amax(dim=(-1, -2))
    min_y = torch.where(mask, ys, big).amin(dim=(-1, -2))
    max_y = torch.where(mask, ys, -1).amax(dim=(-1, -2))
    box = torch.stack([min_x, min_y, max_x, max_y], dim=-1)
    return torch.where(any_fg[..., None], box, 0)


def box_iou(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) XYXY boxes -> (N, N), in the boxes' dtype and
    JAX ``box_iou``'s operation order."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp(min=1e-6)


def nms_keep(boxes, scores, valid, iou_thresh: float) -> np.ndarray:
    """Greedy box NMS as a keep mask (torchvision.ops.nms over the valid
    entries; reference automatic_mask_generator.py:302-311 uses
    batched_nms with one category).

    The f32 IoU matrix is computed where ``boxes`` lives, copied to the
    host once, and the greedy pass walks the candidates in descending
    score, ties to the lowest index (JAX's ``argmax`` loop); the IoU is
    compared with the threshold in f32."""
    boxes = torch.as_tensor(boxes).float()
    iou = box_iou(boxes).cpu().numpy()
    scores = np.where(np.asarray(valid, bool),
                      np.asarray(scores, np.float32), -np.inf)
    thresh = np.float32(iou_thresh)
    n = len(scores)
    keep = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    for j in np.argsort(-scores, kind="stable"):
        if suppressed[j]:
            continue
        if scores[j] > -np.inf:
            keep[j] = True
            suppressed |= iou[j] > thresh
        suppressed[j] = True
    return keep


def _take(data: dict, keep: np.ndarray) -> dict:
    """Index every entry of ``data`` (numpy on the host, tensors where they
    live) with the host mask ``keep``."""
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = v[torch.as_tensor(keep, device=v.device)]
        else:
            v = v[keep]
        out[k] = v
    return out


class SamAutomaticMaskGenerator:
    """Grid-prompted whole-image segmentation (reference
    automatic_mask_generator.py:35-380) with the model's weights, on the
    model's device."""

    def __init__(self, sam_model, *, points_per_side: int = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, mask_threshold: float = 0.0,
                 crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask"):
        assert output_mode in ("binary_mask", "uncompressed_rle",
                               "coco_rle"), output_mode
        self.sam = sam_model
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.mask_threshold = mask_threshold
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self._grids = build_all_layer_point_grids(
            points_per_side, crop_n_layers, crop_n_points_downscale_factor)

    @property
    def device(self) -> torch.device:
        return next(self.sam.parameters()).device

    def _decode_batch(self, emb: torch.Tensor, coords: torch.Tensor):
        """coords (B, 1, 2) -> the B·3 multimask logits and their IoU,
        stability, box and area, on the device."""
        labels = torch.ones(coords.shape[:2], dtype=torch.int32,
                            device=coords.device)
        low_res, iou = self.sam.decode(emb, coords, labels, None, None, True,
                                       True)
        masks = low_res.reshape(-1, *low_res.shape[-2:])
        stab = stability_score(masks, self.mask_threshold,
                               self.stability_score_offset)
        fg = masks > self.mask_threshold
        return (masks, iou.reshape(-1), stab, mask_to_box(fg),
                fg.sum(dim=(-1, -2)))

    def _encode(self, image: np.ndarray):
        """A crop through the predictor's ``set_image`` path: (embedding,
        its (ih, iw) valid frame)."""
        return encode_image_array(self.sam, image)

    def _process_crop(self, emb, crop_box, layer_idx, image_size,
                      frame_hw):
        """Decode the layer's point grid against one crop's embedding.
        Returns the kept candidates: low-res masks on the device, the rest
        on the host with the geometry mapped to the original frame
        (reference _process_crop, :228-260)."""
        x0, y0, x1, y1 = crop_box
        ch, cw = y1 - y0, x1 - x0
        ih, iw = frame_hw
        # grid fractions of the crop -> SAM-frame coords
        coords_all = (self._grids[layer_idx]
                      * np.array([iw, ih])).astype(np.float32)
        n = coords_all.shape[0]
        low_side = image_size // 4  # the decoder's low-res frame
        # low-res -> crop pixels -> original frame
        sy = (image_size / low_side) * (ch / ih)
        sx = (image_size / low_side) * (cw / iw)

        masks, ious, stabs, boxes, areas, points = [], [], [], [], [], []
        for i in range(0, n, self.points_per_batch):
            chunk = coords_all[i:i + self.points_per_batch][:, None, :]
            m, io, st, bx, ar = self._decode_batch(
                emb, torch.as_tensor(chunk, device=self.device))
            keepable = (io > self.pred_iou_thresh) & \
                (st > self.stability_score_thresh)
            idx = torch.nonzero(keepable)[:, 0]
            masks.append(m[idx])
            host = torch.cat([io[idx, None], st[idx, None],
                              bx[idx].float(), ar[idx, None].float()],
                             dim=1).cpu().numpy()
            ious.append(host[:, 0])
            stabs.append(host[:, 1])
            boxes.append(host[:, 2:6].astype(np.int64))
            areas.append(host[:, 6].astype(np.int64))
            # each grid point yields 3 multimask candidates
            pts = np.repeat(chunk[:, 0], m.shape[0] // chunk.shape[0],
                            axis=0)
            # back to original-image coords
            pts = pts * np.array([cw / iw, ch / ih]) + np.array([x0, y0])
            points.append(pts[idx.cpu().numpy()])

        boxes = np.concatenate(boxes).astype(np.float32)
        if boxes.shape[0]:
            boxes = boxes * np.array([sx, sy, sx, sy]) + \
                np.array([x0, y0, x0, y0])
        iou = np.concatenate(ious)
        rec = {
            "low_res": torch.cat(masks),
            "iou": iou,
            "stab": np.concatenate(stabs),
            "box": boxes.reshape(-1, 4),
            "area": (np.concatenate(areas) * sy * sx).astype(np.float32),
            "point": np.concatenate(points).reshape(-1, 2),
            "crop_box": np.repeat(np.asarray([crop_box], np.float32),
                                  len(iou), axis=0),
        }
        # per-crop NMS by predicted IoU (reference :250-257); box IoU is
        # scale/offset-invariant, so original-frame boxes keep the same set
        if rec["box"].shape[0]:
            rec = _take(rec, nms_keep(rec["box"], rec["iou"],
                                      np.ones(len(iou), bool),
                                      self.box_nms_thresh))
        return rec

    def _upscale_to_original(self, low_res, crop_box, image_size,
                             frame_hw, original_size) -> torch.Tensor:
        """(K, 4h, 4w) low-res logits of one crop -> the crop's frame ->
        pasted at the crop's offset in original-size boolean canvases
        (reference uncrop_masks), on the device."""
        x0, y0, x1, y1 = (int(v) for v in crop_box)
        ch, cw = y1 - y0, x1 - x0
        ih, iw = frame_hw
        up = resize_bilinear(low_res, (image_size, image_size))[:, :ih, :iw]
        up = resize_bilinear(up, (ch, cw))
        seg = torch.zeros((low_res.shape[0], *original_size), dtype=torch.bool,
                          device=low_res.device)
        seg[:, y0:y1, x0:x1] = up > self.mask_threshold
        return seg

    @torch.no_grad()
    def generate(self, image_embedding=None,
                 original_size: tuple[int, int] | None = None,
                 image_size: int | None = None, *,
                 image: np.ndarray | None = None) -> list[dict[str, Any]]:
        """image_embedding: (1, 256, h, w) from ``sam.encode_image`` of the
        FULL image (its frame the longest-side resize of
        ``original_size``); ``image`` (H, W, 3) is required when
        ``crop_n_layers > 0``, so that the crops can be re-encoded.
        ``image_size`` is the model's encoder frame unless given.

        Returns reference-style records sorted by area: {'segmentation'
        (per ``output_mode``; a numpy bool mask for binary_mask), 'area',
        'predicted_iou', 'stability_score', 'bbox' XYWH, 'point_coords',
        'crop_box' XYWH}."""
        if original_size is None:
            original_size = image.shape[:2]
        image_size = image_size or self.sam.image_size
        original_size = tuple(int(v) for v in original_size)
        frame_full = longest_side_size(original_size[0], original_size[1],
                                       image_size)
        crop_boxes, layer_idxs = generate_crop_boxes(
            original_size, self.crop_n_layers, self.crop_overlap_ratio)
        if self.crop_n_layers > 0 and image is None:
            raise ValueError("crop_n_layers > 0 requires the image "
                             "(crops are re-encoded)")

        recs = []
        for i, (crop_box, layer) in enumerate(zip(crop_boxes, layer_idxs)):
            if layer == 0 and image_embedding is not None:
                emb, frame = image_embedding, frame_full
            else:
                x0, y0, x1, y1 = crop_box
                emb, frame = self._encode(image[y0:y1, x0:x1])
            rec = self._process_crop(emb, crop_box, layer, image_size, frame)
            rec["crop"] = np.full(len(rec["iou"]), i)
            recs.append((rec, frame))

        data = {k: (torch.cat([r[0][k] for r in recs]) if k == "low_res"
                    else np.concatenate([r[0][k] for r in recs]))
                for k in recs[0][0]}
        if data["iou"].shape[0] == 0:
            return []

        # cross-crop dedup preferring smaller crops (reference :211-223)
        if len(crop_boxes) > 1:
            cb = data["crop_box"]
            crop_area = (cb[:, 2] - cb[:, 0]) * (cb[:, 3] - cb[:, 1])
            data = _take(data, nms_keep(
                data["box"], 1.0 / crop_area, np.ones(len(crop_area), bool),
                self.crop_nms_thresh))

        # upscale the kept masks into the original frame, a crop at a time
        segs = torch.empty((len(data["iou"]), *original_size),
                           dtype=torch.bool, device=data["low_res"].device)
        for i in np.unique(data["crop"]):
            sel = np.nonzero(data["crop"] == i)[0]
            segs[torch.as_tensor(sel, device=segs.device)] = \
                self._upscale_to_original(
                    data["low_res"][torch.as_tensor(sel,
                                                    device=segs.device)],
                    crop_boxes[i], image_size, recs[i][1], original_size)

        # small-region postprocess (reference postprocess_small_regions,
        # :355-380): fill holes, drop islands, NMS preferring unchanged
        if self.min_mask_region_area > 0:
            scores = []
            for i in range(segs.shape[0]):
                seg, ch1 = remove_small_regions(
                    segs[i], self.min_mask_region_area, "holes")
                seg, ch2 = remove_small_regions(
                    seg, self.min_mask_region_area, "islands")
                segs[i] = seg
                scores.append(0.0 if (ch1 or ch2) else 1.0)
            boxes = mask_to_box(segs).cpu().numpy().astype(np.float32)
            keep = nms_keep(boxes, np.asarray(scores, dtype=np.float32),
                            np.ones(len(boxes), bool),
                            max(self.box_nms_thresh, self.crop_nms_thresh))
            segs = segs[torch.as_tensor(keep, device=segs.device)]
            data = _take(data, keep)
            data["box"] = boxes[keep]

        out = []
        host = segs.cpu().numpy()
        areas = host.sum(axis=(1, 2))
        for i in np.argsort(-areas):
            seg = host[i]
            rle = mask_to_rle(seg)
            if self.output_mode == "coco_rle":
                segment = coco_encode_rle(rle)
            elif self.output_mode == "uncompressed_rle":
                segment = rle
            else:
                segment = seg
            x0, y0, x1, y1 = data["box"][i]
            cx0, cy0, cx1, cy1 = data["crop_box"][i]
            out.append({
                "segmentation": segment,
                "area": int(areas[i]),
                "predicted_iou": float(data["iou"][i]),
                "stability_score": float(data["stab"][i]),
                "bbox": [float(x0), float(y0), float(x1 - x0),
                         float(y1 - y0)],
                "point_coords": [data["point"][i].tolist()],
                "crop_box": [float(cx0), float(cy0), float(cx1 - cx0),
                             float(cy1 - cy0)],
            })
        return out
