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
and its masks come back in one copy, which is the one wait on the device.
The call is one ``eval.run`` span (``utils/profiling.py``) over
``eval.load_fold`` (the ``data.*`` spans, run on ``workers`` threads, and
the ``files`` decompressed), ``eval.support``,
``eval.gather_queries``, then per chunk ``eval.to_device``,
``eval.segment`` (the ``pipeline.*`` spans, ended by the masks' copy) and
``eval.score``, and last ``eval.detection``; ``slices_per_sec`` is the
scored slices over ``eval.run``'s duration, the fold's load included.

``base_model="SAM"`` runs the oracle baseline instead
(``run_eval_sam_oracle``): SAM's automatic masks of each slice, the best
against the label scored.  ``dataset="polyps"`` runs the polyp one-shot
eval (``run_eval_polyp``): RGB PNGs, one ``forward`` an image.
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
from protosam_tpu_torch.data.polyp import PolypDataset
from protosam_tpu_torch.entry import _allocate, build_pipeline
from protosam_tpu_torch.eval import open_fold
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.models.samwrapper import SamWrapper
from protosam_tpu_torch.pipeline.protomedsam import ProtoMedSAM
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils import profiling
from protosam_tpu_torch.utils.checkpoint import load_params
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.detection import (eval_detection,
                                                get_bounding_box)
from protosam_tpu_torch.utils.metrics import dice_iou_precision_recall

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


def _all_labels(cfg: Config) -> list:
    """The labels of the dataset's ``pa_all`` group, which both ProtoSAM
    evals load."""
    base = cfg.dataset.split("_")[0]
    return sorted(DATASET_INFO[base]["LABEL_GROUP"]["pa_all"])


def run_eval(cfg: Config, pipe: ProtoSAM | SamWrapper | None = None,
             mode: str = "volume", profile: bool = False) -> dict:
    """Segment the fold of ``cfg`` and score it; ``pipe`` defaults to
    ``build_models(cfg)`` on the card and runs wherever its weights are.
    With ``base_model="SAM"`` it is the oracle's ``SamWrapper``
    (``run_eval_sam_oracle``).  ``dataset="polyps"`` runs
    ``run_eval_polyp`` whatever ``base_model`` says: JAX asks for
    ``base_model`` first, and its oracle then fails on a polyp fold
    (``DATASET_INFO`` has no ``polyps``).  With ``profile`` the result
    also holds ``trace``: ``profiling.summary`` of the call's own spans
    (count, total, self and, with tracing enabled, device ms a name, and
    the counts on them).  The ``eval.run`` span, and ``slices_per_sec``,
    cover the fold's load and not the building of ``pipe``."""
    if cfg.dataset.lower() == "polyps":
        return run_eval_polyp(cfg, pipe)
    if cfg.base_model.upper() == "SAM":
        return run_eval_sam_oracle(cfg, wrapper=pipe)
    pipe = pipe or build_models(cfg)
    dev = next(pipe.coarse_model.parameters()).device
    with profiling.span("eval.run", mode=mode) as run:
        with profiling.span("eval.load_fold") as load:
            te_dataset, volumes = open_fold(cfg, _all_labels(cfg))
            te_dataset.set_curr_cls(resolve_test_class(cfg))
            load.attrs["scans"] = len(volumes.scan_z_idx)
            load.attrs["workers"] = volumes.load_workers

        with profiling.span("eval.support"):
            sup = te_dataset.get_support_set(
                {"support_idx": cfg.support_idx, "task": cfg.task})
        all_sup_imgs = sup["support_images"]
        all_sup_masks = sup["support_labels"]
        support_scan_ids = set(sup["support_scan_id"])

        mean_dice, mean_prec, mean_rec, mean_iou = [], [], [], []
        dice_cases, iou_cases = defaultdict(list), defaultdict(list)
        bboxes_w_scores = []
        n_slices = 0

        # group queries by part_assign so each support swap batches its chunk
        chunks: dict[int, list[dict]] = defaultdict(list)
        with profiling.span("eval.gather_queries") as gather:
            skipped_support = skipped_no_organ = 0
            for idx in range(len(te_dataset)):
                s = te_dataset[idx]
                if s["scan_id"] in support_scan_ids:
                    skipped_support += 1  # reference :364 skips support scans
                    continue
                if cfg.skip_no_organ_slices and s["label"].max() < 1:
                    skipped_no_organ += 1
                    continue
                chunks[int(s["part_assign"])].append(s)
            gather.attrs.update(
                kept=sum(len(c) for c in chunks.values()),
                skipped_support=skipped_support,
                skipped_no_organ=skipped_no_organ)

        for qpart in sorted(chunks):
            samples = chunks[qpart]
            with profiling.span("eval.to_device") as copy:
                sup_img = np.asarray(all_sup_imgs[qpart])
                if sup_img.ndim == 3:
                    sup_img = sup_img[None]
                sup_msk = np.asarray(all_sup_masks[qpart])
                if sup_msk.ndim == 2:
                    sup_msk = sup_msk[None]
                stacked = np.stack([s["image"] for s in samples])
                copy.attrs["bytes"] = (stacked.nbytes + sup_img.nbytes
                                       + sup_msk.nbytes)
                queries = torch.from_numpy(stacked).to(dev)
                inp = ALPNetInput(torch.from_numpy(sup_img).to(dev),
                                  torch.from_numpy(sup_msk).to(dev),
                                  queries[:1], isval=True,
                                  val_wsize=cfg.val_wsize)

            # the masks' copy to the host ends the chunk's device work
            with profiling.span("eval.segment", slices=len(samples)):
                if mode == "volume":
                    preds, _ = pipe.forward_volume(
                        queries, inp, slice_batch=cfg.slice_batch)
                else:
                    preds = torch.stack(
                        [pipe.forward(queries[i:i + 1], inp)[0]
                         for i in range(len(samples))])
                preds = preds.cpu().numpy()

            with profiling.span("eval.score"):
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

        detection = None
        if bboxes_w_scores:
            with profiling.span("eval.detection"):
                detection = eval_detection(bboxes_w_scores)
        run.attrs["slices"] = n_slices

    elapsed = run.duration_ns() / 1e9
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
        result["trace"] = profiling.summary(profiling.spans(within=run))
        log.info("trace:\n%s", profiling.report(result["trace"]))
    if detection is not None:
        result["detection_f1"] = detection
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


def build_sam_oracle(cfg: Config, device: torch.device | str = "cuda",
                     sam_state: dict | None = None,
                     **amg_kwargs) -> SamWrapper:
    """The oracle's SAM (``SAM_VERSIONS.get(cfg.protosam_sam_ver,
    "vit_b")`` at 1024) on ``device``, its encoder in ``cfg.dtype``, with
    the weights of ``sam_state``, else of ``cfg.reload_model_path`` (a SAM
    ``.pth``, ``utils.checkpoint.load_params``), else seeded from
    ``cfg.seed``; wrapped with the automatic mask generator's
    ``amg_kwargs``."""
    if sam_state is None and cfg.reload_model_path:
        sam_state = load_params(cfg.reload_model_path)
    with torch.device("meta"):
        sam = build_sam(SAM_VERSIONS.get(cfg.protosam_sam_ver, "vit_b"),
                        image_size=SAM_IMAGE_SIZE)
    _allocate(sam, device, cfg.seed, sam_state)
    cast_compute(sam.image_encoder, torch.bfloat16
                 if cfg.dtype == "bfloat16" else torch.float32)
    return SamWrapper(sam, **amg_kwargs)


def run_eval_sam_oracle(cfg: Config, wrapper: SamWrapper | None = None
                        ) -> dict:
    """base_model=SAM oracle baseline (reference ProtoSAM.py:170-179 +
    SamWrapper.py; JAX ``run_eval_sam_oracle``): every mask the automatic
    mask generator finds in a slice, the best against the label scored.
    ``wrapper`` defaults to ``build_sam_oracle(cfg)`` on the card.  Every
    test slice is a query (support scans included, as in JAX); the slices
    reach SAM as uint8 min-max images."""
    te_dataset, _ = open_fold(cfg, _all_labels(cfg))
    te_dataset.set_curr_cls(resolve_test_class(cfg))
    wrapper = wrapper or build_sam_oracle(cfg)

    dice_list, cases = [], defaultdict(list)
    t0 = time.time()
    for idx in range(len(te_dataset)):
        s = te_dataset[idx]
        if cfg.skip_no_organ_slices and s["label"].max() < 1:
            continue
        img = np.asarray(s["image"]).transpose(1, 2, 0)
        img = ((img - img.min()) / (img.max() - img.min() + 1e-9) * 255
               ).astype(np.uint8)
        pred = wrapper(img, s["label"])
        m = dice_iou_precision_recall(pred, s["label"])
        dice_list.append(m["dice"])
        cases[s["case"]].append(m["dice"])
    elapsed = time.time() - t0
    return {
        "mar_val_batches_meanDice": float(np.mean(dice_list))
        if dice_list else float("nan"),
        "cases": {k: {"meanDice": float(np.mean(v))} for k, v in
                  cases.items()},
        "n_slices": len(dice_list),
        "slices_per_sec": len(dice_list) / elapsed if elapsed > 0 else 0.0,
    }


def run_eval_polyp(cfg: Config, pipe: ProtoSAM | None = None) -> dict:
    """Polyp one-shot eval (reference validation_protosam.py:244-249,
    307-313; JAX ``run_eval_polyp``): the support drawn from the train
    split, every test image a query, one ``pipe.forward`` each at the SAM
    frame (``cfg.input_size[0]`` from 256 up, else 1024).  ``pipe``
    defaults to ``build_models(cfg)`` on the card and runs wherever its
    weights are."""
    sam_frame = cfg.input_size[0] if cfg.input_size[0] >= 256 else 1024
    tr = PolypDataset(cfg.data_dir("polyps"), train=True,
                      image_size=sam_frame, seed=cfg.seed)
    te = PolypDataset(cfg.data_dir("polyps"), train=False,
                      image_size=sam_frame, seed=cfg.seed)
    pipe = pipe or build_models(cfg)
    dev = next(pipe.coarse_model.parameters()).device

    sup_imgs, sup_gts, _ = tr.get_support(
        n_support=cfg.n_support, text_file=cfg.support_txt_file)
    sup_img = torch.from_numpy(np.concatenate(sup_imgs, axis=0)).to(dev)
    sup_msk = torch.from_numpy(np.concatenate(sup_gts, axis=0)).to(dev)

    mean_dice, mean_prec, mean_rec, mean_iou = [], [], [], []
    cases = defaultdict(list)
    t0 = time.time()
    for i in range(len(te)):
        s = te[i]
        qry = torch.from_numpy(s["image"])[None].to(dev)
        inp = ALPNetInput(sup_img, sup_msk, qry, isval=True,
                          val_wsize=cfg.val_wsize)
        pred, _ = pipe.forward(qry, inp)
        m = dice_iou_precision_recall(pred.cpu().numpy(), s["label"])
        mean_dice.append(m["dice"])
        mean_prec.append(m["precision"])
        mean_rec.append(m["recall"])
        mean_iou.append(m["iou"])
        cases[s["case"]].append(m["dice"])
    elapsed = time.time() - t0
    return {
        "mar_val_batches_meanDice": float(np.mean(mean_dice)),
        "mar_val_batches_meanPrec": float(np.mean(mean_prec)),
        "mar_val_al_batches_meanRec": float(np.mean(mean_rec)),
        "mar_val_al_batches_meanIOU": float(np.mean(mean_iou)),
        "cases": {k: {"meanDice": float(np.mean(v))}
                  for k, v in cases.items()},
        "n_slices": len(te),
        "slices_per_sec": len(te) / elapsed if elapsed else 0.0,
    }
