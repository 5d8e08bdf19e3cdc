"""Evaluation metrics — parity with reference util/metric.py and
validation_protosam.get_dice_iou_precision_recall (:169-185).

A copy of ``protosam_tpu/utils/metrics.py`` (numpy only), so that this
package needs no JAX."""

from __future__ import annotations

import numpy as np


def dice_iou_precision_recall(pred: np.ndarray, gt: np.ndarray) -> dict:
    """Per-slice binary metrics (reference validation_protosam.py:169-185):
    returns zeros when the ground truth is empty."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if gt.sum() == 0:
        return {"dice": 0.0, "iou": 0.0, "precision": 0.0, "recall": 0.0}
    tp = (pred * gt).sum()
    fp = (pred * (1 - gt)).sum()
    fn = ((1 - pred) * gt).sum()
    return {
        "dice": float(2 * tp / (2 * tp + fp + fn + 1e-8)),
        "iou": float(tp / (tp + fp + fn + 1e-8)),
        "precision": float(tp / (tp + fp + 1e-8)),
        "recall": float(tp / (tp + fn + 1e-8)),
    }


class Metric:
    """Scan-level TP/FP/FN accumulator (reference util/metric.py:8-241).

    Per (scan, slice) a length-(max_label+1) array of per-class TP/FP/FN is
    recorded (NaN where not evaluated); aggregation sums over slices per
    scan, computes per-scan-per-class scores, then means/stds across scans.
    """

    def __init__(self, max_label: int = 20, n_scans: int | None = None):
        self.labels = list(range(max_label + 1))
        self.n_scans = 1 if n_scans is None else n_scans
        self.reset()

    def reset(self):
        self.tp_lst = [[] for _ in range(self.n_scans)]
        self.fp_lst = [[] for _ in range(self.n_scans)]
        self.fn_lst = [[] for _ in range(self.n_scans)]

    def reset_scan(self, n_scan: int, labels: list | None = None):
        labels = self.labels if labels is None else labels
        for sl in range(len(self.tp_lst[n_scan])):
            for lb in labels:
                self.tp_lst[n_scan][sl][lb] = np.nan
                self.fp_lst[n_scan][sl][lb] = np.nan
                self.fn_lst[n_scan][sl][lb] = np.nan

    def record(self, pred, target, labels=None, n_scan=None):
        pred = np.asarray(pred)
        target = np.asarray(target)
        assert pred.shape == target.shape
        if self.n_scans == 1:
            n_scan = 0
        tp_arr = np.full(len(self.labels), np.nan)
        fp_arr = np.full(len(self.labels), np.nan)
        fn_arr = np.full(len(self.labels), np.nan)
        # NOTE (reference quirk, metric.py:76-97): when a label subset is
        # given, class j in the *prediction* is compared against class j in
        # the target but stored at slot labels[j] — i.e. binary preds are
        # compared as pred==0/1 regardless of the true label id.
        lbls = self.labels if labels is None else [0] + list(labels)
        for j, label in enumerate(lbls):
            tp_arr[label] = ((pred == j) & (target == j)).sum()
            fp_arr[label] = ((pred == j) & (target != j)).sum()
            fn_arr[label] = ((pred != j) & (target == j)).sum()
        self.tp_lst[n_scan].append(tp_arr)
        self.fp_lst[n_scan].append(fp_arr)
        self.fn_lst[n_scan].append(fn_arr)

    def _sums(self, labels, n_scan):
        tp = np.nansum(np.vstack(self.tp_lst[n_scan]), axis=0).take(labels)
        fp = np.nansum(np.vstack(self.fp_lst[n_scan]), axis=0).take(labels)
        fn = np.nansum(np.vstack(self.fn_lst[n_scan]), axis=0).take(labels)
        return tp, fp, fn

    def _classwise(self, labels, formula):
        rows = []
        for s in range(self.n_scans):
            tp, fp, fn = self._sums(labels, s)
            with np.errstate(invalid="ignore", divide="ignore"):
                rows.append(formula(tp, fp, fn))
        return np.vstack(rows)

    def get_mDice(self, labels=None, n_scan=None, give_raw=False):
        labels = self.labels if labels is None else labels
        f = lambda tp, fp, fn: 2 * tp / (2 * tp + fp + fn)
        if n_scan is not None:
            tp, fp, fn = self._sums(labels, n_scan)
            cls = f(tp, fp, fn)
            return cls, cls.mean(), cls
        cls = self._classwise(labels, f)
        m = cls.mean(axis=1)
        out = (cls.mean(axis=0), cls.std(axis=0), m.mean(), m.std())
        return out + ((cls,) if give_raw else ())

    def get_mIoU(self, labels=None, n_scan=None):
        labels = self.labels if labels is None else labels
        f = lambda tp, fp, fn: tp / (tp + fp + fn)
        if n_scan is not None:
            tp, fp, fn = self._sums(labels, n_scan)
            cls = f(tp, fp, fn)
            return cls, cls.mean()
        cls = self._classwise(labels, f)
        m = cls.mean(axis=1)
        return cls.mean(axis=0), cls.std(axis=0), m.mean(), m.std()

    def get_mPrecRecall(self, labels=None, n_scan=None, give_raw=False):
        labels = self.labels if labels is None else labels
        fp_f = lambda tp, fp, fn: tp / (tp + fp)
        fr_f = lambda tp, fp, fn: tp / (tp + fn)
        if n_scan is not None:
            tp, fp, fn = self._sums(labels, n_scan)
            p, r = fp_f(tp, fp, fn), fr_f(tp, fp, fn)
            return (p, None, p.mean(), None, r, None, r.mean(), None, p, r)
        pc = self._classwise(labels, fp_f)
        rc = self._classwise(labels, fr_f)
        mp, mr = pc.mean(axis=1), rc.mean(axis=1)
        out = (pc.mean(axis=0), pc.std(axis=0), mp.mean(), mp.std(),
               rc.mean(axis=0), rc.std(axis=0), mr.mean(), mr.std())
        return out + ((pc, rc) if give_raw else ())
