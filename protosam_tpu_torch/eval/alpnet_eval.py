"""ALPNet-only evaluation driver (JAX ``eval/alpnet_eval.py``; reference
validation.py:100-367).

Per test class: the 3-chunk support, the fold's slices grouped by scan and
support chunk, the coarse model on a chunk's slices in batches of
``slice_batch`` (optionally CCA keep-most-confident on kernel K3, and
test-time training per slice), 3-D prediction volumes, scan-level TP/FP/FN
inside the z-margin window, NIfTI predictions, class and mean
Dice/Prec/Rec.  The model is ``train.trainer.build_coarse_model``'s: f32
master weights computing in ``cfg.dtype``, as JAX's ``FewShotSeg(dtype)``
over f32 params, which test-time training steps.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict

import numpy as np
import torch

from protosam_tpu_torch.data.dataset_registry import DATASET_INFO
from protosam_tpu_torch.data.nifti import write_nii
from protosam_tpu_torch.eval import open_fold
from protosam_tpu_torch.eval.ttt import test_time_training
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.ops.cca import components
from protosam_tpu_torch.ops.resize import resize_nearest
from protosam_tpu_torch.train.trainer import build_coarse_model
from protosam_tpu_torch.utils.checkpoint import load_params
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.metrics import Metric

log = logging.getLogger("alpnet_eval")


@torch.no_grad()
def coarse_predict(model: FewShotSeg, supp, fg, bg, qrys, val_wsize: int,
                   do_cca: bool, max_ccs: int = 8,
                   slice_batch: int = 4) -> torch.Tensor:
    """Support (S, 3, H, W) + masks (S, H, W) and queries (N, 3, H, W) ->
    (N, H, W) f32 class predictions, ``slice_batch`` queries a forward;
    ``do_cca`` keeps only the most confident component (reference
    validation.py:291-295 multiplies the argmax by its mask)."""
    preds = []
    for chunk in qrys.split(slice_batch):
        logits = model(supp, fg, bg, chunk, isval=True,
                       val_wsize=val_wsize)["logits"]
        pred = torch.argmax(logits, dim=1).float()
        if do_cca:
            stats, _ = components(pred, torch.softmax(logits, dim=1)[:, 1],
                                  max_ccs, True)
            pred = pred * (stats.labels > 0)
        preds.append(pred)
    return torch.cat(preds)


def run_alpnet_eval(cfg: Config, model: FewShotSeg | None = None,
                    state_dict: dict | None = None,
                    slice_batch: int | None = None,
                    write_preds: bool = True,
                    device: torch.device | str = "cuda",
                    max_slices: int | None = None) -> dict:
    """Evaluate the fold of ``cfg``.  ``model`` defaults to
    ``build_coarse_model(cfg, device)`` with ``state_dict``, else the
    weights of ``cfg.reload_model_path``, else seeded ones; the card
    unless the caller asks for the CPU.  ``max_slices`` keeps only the
    first that many query slices of each class (a smoke run's cut); the
    scores then average over the scans those slices came from."""
    baseset = cfg.dataset.split("_")[0]
    info = DATASET_INFO[baseset]
    test_labels = sorted(info["LABEL_GROUP"]["pa_all"]
                         - info["LABEL_GROUP"][cfg.label_sets])
    max_label = len(info["REAL_LABEL_NAME"]) - 1
    slice_batch = slice_batch or cfg.slice_batch
    te_dataset, te_parent = open_fold(cfg, test_labels)

    if model is None:
        if state_dict is None and cfg.reload_model_path:
            state_dict = load_params(cfg.reload_model_path)
        model = build_coarse_model(cfg, device, state_dict)
    dev = next(model.parameters()).device
    as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)

    records = []            # (scan index, pred, label, class)
    save_pred_buffer = {}

    for curr_lb in test_labels:
        te_dataset.set_curr_cls(curr_lb)
        sup = te_parent.get_support(curr_class=curr_lb, class_idx=[curr_lb],
                                    scan_idx=cfg.support_idx,
                                    npart=cfg.n_sup_part)
        sup_imgs = [as_t(x) for x in sup["support_images"][0]]
        sup_fg = [as_t(m["fg_mask"]) for m in sup["support_mask"][0]]
        sup_bg = [as_t(m["bg_mask"]) for m in sup["support_mask"][0]]

        by_scan: dict[str, list[dict]] = defaultdict(list)
        for idx in range(len(te_dataset)):
            s = te_dataset[idx]
            if s["scan_id"] in te_parent.potential_support_sid:
                continue
            by_scan[s["scan_id"]].append(s)

        _lb_buffer = {}
        budget = max_slices
        for scan_count, (scan_id, slices) in enumerate(by_scan.items()):
            nz = len(te_parent.scan_z_idx[scan_id])
            vol_pred = np.full((cfg.input_size[0], cfg.input_size[1], nz),
                               np.nan)
            groups: dict[int, list[dict]] = defaultdict(list)
            for s in slices:
                if budget is not None and budget <= 0:
                    break
                if (s["label"].max() >= 1 or s["is_end"]
                        or not cfg.skip_no_organ_slices):
                    groups[int(s["part_assign"])].append(s)
                    budget = None if budget is None else budget - 1
            for qpart, ss in groups.items():
                qrys = as_t(np.stack([x["image"] for x in ss]))
                sup_i = (sup_imgs[qpart][None] if sup_imgs[qpart].ndim == 3
                         else sup_imgs[qpart])
                sup_f = (sup_fg[qpart][None] if sup_fg[qpart].ndim == 2
                         else sup_fg[qpart])
                sup_b = (sup_bg[qpart][None] if sup_bg[qpart].ndim == 2
                         else sup_bg[qpart])
                predict = lambda q: coarse_predict(
                    model, sup_i, sup_f, sup_b, q, cfg.val_wsize,
                    cfg.do_cca, cfg.max_ccs, slice_batch)
                preds = predict(qrys)
                if cfg.ttt:
                    # test-time training per slice on its coarse pred, then
                    # predict again; the group starts from the weights it
                    # found, and with reset_after_slice so does every slice
                    # (reference validation.py:273-281)
                    base = {k: v.clone()
                            for k, v in model.state_dict().items()}
                    new_preds = []
                    for i, p0 in enumerate(preds.cpu().numpy()):
                        test_time_training(
                            model, np.asarray(ss[i]["image"]),
                            p0.astype(np.float32), which_aug=cfg.which_aug,
                            lr=cfg.lr, optim_type=cfg.optim_type,
                            seed=cfg.seed)
                        new_preds.append(predict(qrys[i:i + 1]))
                        if cfg.reset_after_slice:
                            model.load_state_dict(base)
                    model.load_state_dict(base)
                    preds = torch.cat(new_preds)
                preds = resize_nearest(preds[:, None],
                                       tuple(ss[0]["label"].shape))[:, 0]
                for s, p in zip(ss, preds.cpu().numpy()):
                    vol_pred[..., s["z_id"]] = p
                    in_margin = (s["z_id"] - s["z_max"] <= cfg.z_margin and
                                 s["z_id"] - s["z_min"] >= -cfg.z_margin)
                    if in_margin and not s["is_end"]:
                        records.append((scan_count, p, s["label"], curr_lb))
            _lb_buffer[scan_id] = vol_pred.transpose(2, 0, 1)
        save_pred_buffer[str(curr_lb)] = _lb_buffer

    if write_preds and cfg.log_dir:
        outdir = os.path.join(cfg.log_dir, "interm_preds")
        os.makedirs(outdir, exist_ok=True)
        for lb, preds in save_pred_buffer.items():
            for scan_id, p in preds.items():
                write_nii(np.nan_to_num(p * float(lb)).astype(np.float32),
                          os.path.join(outdir,
                                       f"scan_{scan_id}_label_{lb}.nii.gz"),
                          ref=te_parent.info_by_scan[scan_id])

    scans = sorted({r[0] for r in records})
    n_scans = (len(te_parent.pid_curr_load) - 1 if max_slices is None
               else len(scans))
    metric = Metric(max_label=max_label, n_scans=n_scans)
    for scan, p, lbl, lb in records:
        metric.record(p, lbl, labels=[lb], n_scan=scans.index(scan))
    labels = sorted(test_labels)
    cls_dice, _, mean_dice, _, _ = metric.get_mDice(labels=labels,
                                                    give_raw=True)
    pr = metric.get_mPrecRecall(labels=labels, give_raw=True)
    result = {
        "classDice": dict(zip(map(str, labels), map(float, cls_dice))),
        "meanDice": float(mean_dice),
        "classPrec": dict(zip(map(str, labels), map(float, pr[0]))),
        "meanPrec": float(pr[2]),
        "classRec": dict(zip(map(str, labels), map(float, pr[4]))),
        "meanRec": float(pr[6]),
    }
    log.info("mean Dice: %.4f", result["meanDice"])
    return result
