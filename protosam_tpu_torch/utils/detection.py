"""Detection metrics: bbox-of-mask F1 over IoU 0.50:0.95 (JAX
``utils/detection.py``; reference validation_protosam.py:40-122), in numpy:
no cv2, no pandas."""

from __future__ import annotations

import numpy as np


def get_bounding_box(segmentation_map: np.ndarray) -> tuple:
    """One XYWH box covering the mask's nonzero pixels, with
    ``cv2.boundingRect``'s semantics (reference :50-62): the extent is
    inclusive, and an empty mask gives (0, 0, 0, 0)."""
    m = np.asarray(segmentation_map).astype(np.uint8)
    ys, xs = np.nonzero(m)
    if ys.size == 0:
        return (0, 0, 0, 0)
    x0, y0 = int(xs.min()), int(ys.min())
    return (x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1)


def calc_iou(box_a, box_b) -> float:
    """XYWH box IoU (reference :64-78)."""
    xa = max(box_a[0], box_b[0])
    ya = max(box_a[1], box_b[1])
    xb = min(box_a[0] + box_a[2], box_b[0] + box_b[2])
    yb = min(box_a[1] + box_a[3], box_b[1] + box_b[3])
    inter = max(0, xb - xa) * max(0, yb - ya)
    union = box_a[2] * box_a[3] + box_b[2] * box_b[3] - inter
    return inter / float(union) if union else 0.0


def eval_detection(pred_list: list[dict]) -> list[dict]:
    """Per-threshold TP/FP/precision/recall/F1 rows (reference :81-122), as
    the JAX table's ``to_dict(orient="records")`` gives them.

    pred_list entries: {'pred_bbox': XYWH, 'gt_bbox': XYWH, 'score': float}.
    """
    thresholds = np.round(np.arange(0.5, 1.0, 0.05), 2)
    rows = []
    for t in thresholds:
        tp = int(sum(calc_iou(p["pred_bbox"], p["gt_bbox"]) >= t
                     for p in pred_list))
        fp = len(pred_list) - tp
        precision = tp / (tp + fp) if pred_list else 0.0
        recall = tp / len(pred_list) if pred_list else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        rows.append({"iou_threshold": float(t), "tp": tp, "fp": fp,
                     "n_gt": len(pred_list), "f1": float(f1),
                     "precision": float(precision),
                     "recall": float(recall)})
    return rows
