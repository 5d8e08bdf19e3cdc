"""ProtoSAM evaluation driver (JAX ``eval/protosam_eval.py``; reference
validation_protosam.py:285-451).

``build_models(cfg, device="cuda")`` maps the eval configuration to the
pipeline (``ProtoMedSAM`` for ``protosam_sam_ver="medsam"``), with seeded
synthetic weights from ``cfg.seed``, the coarse model's from
``cfg.reload_model_path`` where set, or the state_dicts given.

``run_eval(cfg)``: build the models, load the fold's volumes, pick the
support set once per run (3 z-chunks; swapped per query's part_assign),
segment every query slice, compute per-slice dice/iou/prec/recall and
aggregate per case and overall.  Two modes:

  * ``per_slice`` — the reference loop, one ``forward`` a slice;
  * ``volume``    — a z-chunk's queries through ``forward_volume`` at
                    ``cfg.slice_batch`` slices a batch.

Either way a chunk's queries reach the device in one host-to-device copy
and its masks come back in one copy.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

from protosam_tpu_torch.data.dataset_registry import (DATASET_INFO,
                                                      ORGAN_CLASS)
from protosam_tpu_torch.data.medical import med_fewshot_val
from protosam_tpu_torch.entry import build_pipeline
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.pipeline.protomedsam import ProtoMedSAM
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.checkpoint import load_params
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.detection import (eval_detection,
                                                get_bounding_box)
from protosam_tpu_torch.utils.metrics import dice_iou_precision_recall
from protosam_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger("protosam_eval")

SAM_VERSIONS = {"sam_h": "vit_h", "sam_b": "vit_b", "sam_l": "vit_l",
                "vit_h": "vit_h", "vit_b": "vit_b", "vit_t": "vit_t",
                "medsam": "vit_b"}
SAM_IMAGE_SIZE = 1024


def build_models(cfg: Config, device: torch.device | str = "cuda",
                 coarse_state: dict | None = None,
                 sam_state: dict | None = None, fused_mlp: bool = False,
                 fused_proj: bool = False) -> ProtoSAM:
    """The pipeline of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU).

    The coarse model's weights come from ``coarse_state``, else from
    ``cfg.reload_model_path`` (an ALPNet ``.pth`` snapshot,
    ``utils.checkpoint.load_params``), else from ``cfg.seed``; SAM's from
    ``sam_state`` (``utils.convert.load_sam_pth``), else from the seed.
    ``cfg.use_fused_alp`` puts the ALP matching on kernel K5,
    ``cfg.quant_dense`` both encoders' dense stages on the int8 path
    (kernels K8 and K9, which turns the two SAM routes off).  The SAM
    encoder routes come from ``fused_mlp`` / ``fused_proj`` (kernels K7 /
    K6, bf16 only), which the JAX package reads from ``PTPU_MLP_PALLAS`` /
    ``PTPU_PROJ_PALLAS``."""
    if coarse_state is None and cfg.reload_model_path:
        coarse_state = load_params(cfg.reload_model_path)
    size = (SAM_IMAGE_SIZE, SAM_IMAGE_SIZE)
    medsam = cfg.protosam_sam_ver == "medsam"
    if medsam:
        # box-only prompts into MedSAM (reference validation_protosam.py
        # :216-238 builds ProtoMedSAM for this setting)
        pconf = ProtoSAMConfig(
            image_size=size, use_points=False, use_bbox=True,
            use_cca=cfg.do_cca, coarse_pred_only=cfg.coarse_pred_only,
            max_ccs=cfg.max_ccs)
    else:
        pconf = ProtoSAMConfig(
            image_size=size,
            num_points_for_sam=1,
            use_points=cfg.use_points,
            use_bbox=cfg.use_bbox,
            use_mask=cfg.use_mask,
            use_neg_points=cfg.use_neg_points,
            use_cca=cfg.do_cca,
            point_mode=cfg.point_mode,
            coarse_pred_only=cfg.coarse_pred_only,
            max_ccs=cfg.max_ccs,
        )
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    pipe = build_pipeline(
        device, sam_ver=SAM_VERSIONS[cfg.protosam_sam_ver],
        coarse=cfg.modelname, image_size=cfg.input_size[0],
        sam_size=SAM_IMAGE_SIZE, dtype=dtype, config=pconf, seed=cfg.seed,
        proto_grid_size=cfg.proto_grid_size,
        use_fused_alp=cfg.use_fused_alp, fused_mlp=fused_mlp,
        fused_proj=fused_proj, quant_dense=cfg.quant_dense,
        coarse_state=coarse_state, sam_state=sam_state)
    if medsam:
        return ProtoMedSAM(pipe.coarse_model, pipe.sam_model, pconf)
    return pipe


def resolve_test_class(cfg: Config) -> int:
    base = cfg.dataset.split("_")[0]
    return ORGAN_CLASS[base][cfg.curr_cls]


def run_eval(cfg: Config, pipe: ProtoSAM | None = None,
             mode: str = "volume", profile: bool = False) -> dict:
    """Segment the fold of ``cfg`` and score it; ``pipe`` defaults to
    ``build_models(cfg)`` on the card and runs wherever its weights are."""
    if cfg.base_model.upper() == "SAM":
        raise NotImplementedError("the base_model=SAM oracle needs the SAM "
                                  "tools, not ported yet (ROADMAP §1 item "
                                  "25, with item 15)")
    if cfg.dataset.lower() == "polyps":
        raise NotImplementedError("the polyp data layer is not ported yet "
                                  "(ROADMAP §1 item 24)")
    base = cfg.dataset.split("_")[0]
    suffix = "_672" if cfg.input_size[0] > 256 else ""
    data_key = base + suffix if base + suffix in cfg.data_dirs else cfg.dataset
    te_dataset, _ = med_fewshot_val(
        dataset_name=base,
        base_dir=cfg.data_dir(data_key),
        idx_split=cfg.eval_fold,
        act_labels=sorted(DATASET_INFO[base]["LABEL_GROUP"]["pa_all"]),
        npart=cfg.n_sup_part,
        image_size=cfg.input_size[0],
        use_clahe=cfg.use_clahe,
        use_3_slices=cfg.use_3_slices,
    )
    te_dataset.set_curr_cls(resolve_test_class(cfg))

    pipe = pipe or build_models(cfg)
    dev = next(pipe.coarse_model.parameters()).device

    sup = te_dataset.get_support_set(
        {"support_idx": cfg.support_idx, "task": cfg.task})
    all_sup_imgs, all_sup_masks = sup["support_images"], sup["support_labels"]
    support_scan_ids = set(sup["support_scan_id"])

    mean_dice, mean_prec, mean_rec, mean_iou = [], [], [], []
    dice_cases, iou_cases = defaultdict(list), defaultdict(list)
    bboxes_w_scores = []

    timer = StageTimer(dev, sync=dev.type == "cuda")
    t0 = time.time()
    n_slices = 0

    # group queries by part_assign so each support swap batches its chunk
    chunks: dict[int, list[dict]] = defaultdict(list)
    for idx in range(len(te_dataset)):
        s = te_dataset[idx]
        if s["scan_id"] in support_scan_ids:
            continue  # reference :364 skips support scans as queries
        if cfg.skip_no_organ_slices and s["label"].max() < 1:
            continue
        chunks[int(s["part_assign"])].append(s)

    for qpart in sorted(chunks):
        samples = chunks[qpart]
        sup_img = np.asarray(all_sup_imgs[qpart])
        if sup_img.ndim == 3:
            sup_img = sup_img[None]
        sup_msk = np.asarray(all_sup_masks[qpart])
        if sup_msk.ndim == 2:
            sup_msk = sup_msk[None]
        queries = torch.from_numpy(
            np.stack([s["image"] for s in samples])).to(dev)
        inp = ALPNetInput(torch.from_numpy(sup_img).to(dev),
                          torch.from_numpy(sup_msk).to(dev), queries[:1],
                          isval=True, val_wsize=cfg.val_wsize)

        if mode == "volume":
            with timer.stage("volume_chunk"):
                preds, _ = pipe.forward_volume(
                    queries, inp, slice_batch=cfg.slice_batch)
                preds = preds.cpu().numpy()
        else:
            preds = torch.stack([pipe.forward(queries[i:i + 1], inp)[0]
                                 for i in range(len(samples))])
            preds = preds.cpu().numpy()

        for s, pred in zip(samples, preds):
            m = dice_iou_precision_recall(pred, s["label"])
            mean_dice.append(m["dice"])
            mean_prec.append(m["precision"])
            mean_rec.append(m["recall"])
            mean_iou.append(m["iou"])
            dice_cases[s["case"]].append(m["dice"])
            iou_cases[s["case"]].append(m["iou"])
            bboxes_w_scores.append({
                "pred_bbox": get_bounding_box(pred),
                "gt_bbox": get_bounding_box(s["label"]),
                "score": m["dice"]})
            n_slices += 1

    elapsed = time.time() - t0
    result = {
        "mar_val_batches_meanDice": float(np.mean(mean_dice)),
        "mar_val_batches_meanPrec": float(np.mean(mean_prec)),
        "mar_val_al_batches_meanRec": float(np.mean(mean_rec)),
        "mar_val_al_batches_meanIOU": float(np.mean(mean_iou)),
        "cases": {k: {"meanDice": float(np.mean(v)),
                      "meanIOU": float(np.mean(iou_cases[k]))}
                  for k, v in dice_cases.items()},
        "n_slices": n_slices,
        "slices_per_sec": n_slices / elapsed if elapsed > 0 else 0.0,
    }
    if profile:
        result["stage_timings"] = timer.as_dict()
        log.info("stage timings:\n%s", timer.report())
    if bboxes_w_scores:
        result["detection_f1"] = eval_detection(bboxes_w_scores)
    log.info("mar_val batches meanDice: %.4f (%d slices, %.1f slices/s)",
             result["mar_val_batches_meanDice"], n_slices,
             result["slices_per_sec"])
    if cfg.log_dir:
        os.makedirs(cfg.log_dir, exist_ok=True)
        # config snapshot per run (the reference's sacred FileStorageObserver
        # records config + sources, config_ssl_upload.py:171-177)
        cfg.save(os.path.join(cfg.log_dir, "config.json"))
        cfg.snapshot_sources(cfg.log_dir)
        with open(os.path.join(cfg.log_dir, "protosam_eval_result.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
    return result
