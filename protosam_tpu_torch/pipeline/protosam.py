"""ProtoSAM pipeline: coarse prototypes -> device-side prompts -> SAM.

Behavioural spec: reference models/ProtoSAM.py:184-678.  Every stage runs
on the model's device, batched over slices, with no host round trip:

  coarse ALPNet logits
  -> f32 bilinear upsample to the SAM frame, softmax, argmax
  -> CCA (kernel K3) (+ keep-best-component 'cca' mode)
  -> per-component top-confidence/centroid points + boxes (padded)
  -> the reference's uint8 min-max renorm (floored) + SAM normalisation
  -> SAM encoder -> decoder batched over slices × components
  -> component masks OR-ed, composed bilinear->nearest resize to the query.

Flag semantics follow reference ProtoSAM.__init__:184-203 with the defaults
of validation_protosam.py:220-232.
"""

from __future__ import annotations

import dataclasses

import torch

from protosam_tpu_torch.models.io_protocol import (ALPNetInput, BOTH_MODE,
                                                   POINT_MODES)
from protosam_tpu_torch.models.sam.sam import preprocess as sam_preprocess
from protosam_tpu_torch.ops.cca import (ComponentStats,
                                        component_confidences,
                                        connected_components)
from protosam_tpu_torch.ops.prompts import build_sam_prompts
from protosam_tpu_torch.ops.resize import (resize_bilinear,
                                           resize_bilinear_then_nearest,
                                           resize_nearest)
from protosam_tpu_torch.ops.rotate import (reverse_tensor,
                                           rotate_tensor_no_crop)


@dataclasses.dataclass(frozen=True)
class ProtoSAMConfig:
    """Static pipeline flags (reference ProtoSAM.__init__:184-203)."""

    image_size: tuple[int, int] = (1024, 1024)
    num_points_for_sam: int = 1
    use_points: bool = True
    use_bbox: bool = True
    use_mask: bool = False
    # reproduce the reference's uint8 cast of the mask prompt, which wraps
    # its -8 background fill to 248 (predict_w_masks, ProtoSAM.py:479); off
    # by default, on to replay masks recorded through that cast
    mask_prompt_uint8_wrap: bool = False
    use_neg_points: bool = False
    use_cca: bool = True
    point_mode: str = BOTH_MODE
    coarse_pred_only: bool = False
    max_ccs: int = 8

    def __post_init__(self):
        if self.point_mode not in POINT_MODES:
            raise ValueError(f"point mode must be one of {POINT_MODES}")
        if not (self.use_bbox or self.use_points or self.use_mask):
            raise ValueError("must use at least one of bbox, points, or mask")


def _keep_best_component(stats: ComponentStats, conf: torch.Tensor
                         ) -> tuple[ComponentStats, torch.Tensor]:
    """'cca' mode (reference util/utils.py:496-541): per slice, reduce the
    component set to the most confident one (slot 0), or none if the best
    confidence is 0.  conf (B, K)."""
    b, k = conf.shape
    best = torch.argmax(conf, dim=1)                           # (B,)
    any_conf = torch.amax(conf, dim=1) > 0
    sel = (torch.arange(k, device=conf.device) == 0)[None]     # (1, K)
    labels = ((stats.labels == (best + 1)[:, None, None])
              & any_conf[:, None, None]).to(torch.int32)
    rows = torch.arange(b, device=conf.device)

    def take(a):
        shape = (b, k) + (1,) * (a.ndim - 2)
        return torch.where(sel.reshape((1, k) + shape[2:]),
                           a[rows, best][:, None], torch.zeros_like(a))

    new = ComponentStats(
        labels=labels, num=any_conf.to(torch.int32),
        valid=sel & any_conf[:, None], areas=take(stats.areas),
        bboxes=take(stats.bboxes), centroids=take(stats.centroids))
    new_conf = torch.where(sel, conf[rows, best][:, None], 0.0) \
        * any_conf[:, None]
    return new, new_conf


def _confidence_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per slice (reference util/utils.py:429-434) -> (B,)."""
    probs = torch.softmax(logits, dim=1)[:, 1].flatten(1)
    pred = (probs >= 0.5).float()
    return (probs * pred).sum(1) / (pred.sum(1) + 1e-6)


class ProtoSAM:
    """API parity with reference ProtoSAM: ``forward(query_image,
    coarse_model_input)`` -> ``(pred, scores)``.  Takes the coarse model
    and SAM as modules carrying their weights; runs where they live."""

    def __init__(self, coarse_model, sam_model,
                 config: ProtoSAMConfig = ProtoSAMConfig()):
        self.coarse_model = coarse_model
        self.sam_model = sam_model
        self.config = config

    @torch.no_grad()
    def _forward_core(self, supp, fg, bg, qrys, supp_fts, isval=True,
                      val_wsize=2):
        """Coarse model + refinement for a batch of query slices
        (N, 3, H, W) -> (preds (N, H, W), scores (N, K))."""
        logits = self.coarse_model(supp, fg, bg, qrys, isval, val_wsize,
                                   supp_fts=supp_fts)["logits"]
        return self._refine_core(qrys, logits)

    @torch.no_grad()
    def _forward_rotated(self, qry, inp: ALPNetInput, degrees: int):
        """Rotation TTA (reference ProtoSAM.py:543-556): the coarse logits
        of the rotated query, rotated back, refined on the query itself."""
        rotated, (rh, rw) = rotate_tensor_no_crop(qry, degrees)
        inp.set_query_images(rotated)
        logits = self.coarse_model(
            inp.supp_imgs, inp.fore_mask, inp.back_mask, rotated, inp.isval,
            inp.val_wsize, supp_fts=inp.supp_fts)["logits"]
        logits = reverse_tensor(logits, rh, rw, -degrees)
        inp.set_query_images(qry)
        return self._refine_core(qry, logits)

    def _refine_core(self, qrys, logits):
        cfg = self.config
        original_size = tuple(qrys.shape[-2:])
        if cfg.coarse_pred_only:
            pred = torch.argmax(logits, dim=1)
            conf = _confidence_from_logits(logits)
            if cfg.use_cca:
                probs = torch.softmax(logits, dim=1)
                stats = connected_components(pred.float(), cfg.max_ccs)
                c = component_confidences(stats, probs[:, 1], pred.float())
                stats, c = _keep_best_component(stats, c)
                pred = (stats.labels > 0) * pred
                conf = torch.amax(c, dim=1)
            return pred.float(), conf[:, None]
        ex = self._extract_prompts(qrys, logits)
        emb = self.sam_model.encode_image(ex["sam_image"])
        return self._decode_stage(
            emb, ex["coords"], ex["labels"], ex["boxes"], ex["valid"],
            ex["pred"], original_size, mask_inputs=ex["mask_inputs"])

    def _extract_prompts(self, qrys, logits):
        """Device-side prompt extraction for B slices: coarse logits ->
        CCA -> points/boxes, plus the preprocessed SAM input images."""
        cfg = self.config
        qimg = resize_bilinear(qrys, cfg.image_size)
        # f32 logit upsample + softmax + argmax: the argmax seeds CCA and
        # every prompt, so its precision decides mask boundaries
        probs = torch.softmax(resize_bilinear(logits.float(),
                                              cfg.image_size), dim=1)
        pred = torch.argmax(probs, dim=1).float()              # (B, H, W)

        stats = connected_components(pred, cfg.max_ccs)
        conf = component_confidences(stats, probs[:, 1], pred)
        if cfg.use_cca:
            # one component at slot 0: shrink the stats to one row before
            # prompt extraction so the per-component work runs once
            stats, conf = _keep_best_component(stats, conf)
            stats = ComponentStats(
                labels=stats.labels, num=stats.num, valid=stats.valid[:, :1],
                areas=stats.areas[:, :1], bboxes=stats.bboxes[:, :1],
                centroids=stats.centroids[:, :1])

        b, k = stats.valid.shape
        if cfg.use_points:
            pts = build_sam_prompts(
                probs[:, 1], probs[:, 0], stats,
                num_points=cfg.num_points_for_sam, point_mode=cfg.point_mode,
                use_neg_points=cfg.use_neg_points)
            coords, labels = pts.coords, pts.labels
        else:
            coords = torch.zeros((b, k, 1, 2), device=pred.device)
            labels = torch.full((b, k, 1), -1, dtype=torch.int32,
                                device=pred.device)
        boxes = stats.bboxes.float() if cfg.use_bbox else None

        mask_inputs = None
        if cfg.use_mask:
            # per-component low-res mask prompts (4x the embedding grid),
            # fg -> 10 / bg -> -8 (reference predict_w_masks, :468-479), or
            # bg -> 248 with mask_prompt_uint8_wrap, as its uint8 cast gives
            side = 4 * (self.sam_model.image_size
                        // self.sam_model.vit_patch_size)
            ids = torch.arange(1, k + 1, dtype=torch.int32,
                               device=pred.device)
            onehot = (stats.labels[:, None] == ids[None, :, None, None])
            low = resize_nearest(onehot.float(), (side, side))
            bg_fill = 248.0 if cfg.mask_prompt_uint8_wrap else -8.0
            mask_inputs = torch.where(low > 0.5, 10.0, bg_fill)[:, :, None]

        # the SAM input: the reference's uint8 min-max renorm quirk
        # (ProtoSAM.py:651-660), floor to uint8 steps, then the predictor's
        # own pixel normalisation
        lo = qimg.amin(dim=(1, 2, 3), keepdim=True)
        hi = qimg.amax(dim=(1, 2, 3), keepdim=True)
        q = torch.floor((qimg - lo) / (hi - lo) * 255.0)
        q = sam_preprocess(q, self.sam_model.image_size)
        return {"sam_image": q, "coords": coords, "labels": labels,
                "boxes": boxes, "valid": stats.valid, "pred": pred,
                "mask_inputs": mask_inputs}

    def _decode_stage(self, emb, coords, labels, boxes, valid, pred,
                      original_size, mask_inputs=None):
        """Batched SAM decode over (B slices × K components).

        emb (B, 256, 64, 64); coords (B, K, P, 2); labels (B, K, P);
        boxes (B, K, 4) | None; valid (B, K); pred (B, Hs, Ws).
        Returns (out (B, H, W), scores (B, K)).
        """
        cfg = self.config
        b, k = coords.shape[:2]
        emb_rep = emb.repeat_interleave(k, dim=0)
        flat = lambda x: x.reshape((b * k,) + tuple(x.shape[2:]))
        if cfg.use_mask and mask_inputs is not None:
            # mask prompts only, multimask output, best score per component
            n = b * k
            low_res, iou = self.sam_model.decode(
                emb_rep, coords.new_zeros((n, 0, 2)),
                labels.new_zeros((n, 0)), None, flat(mask_inputs), True,
                False)
            best = torch.argmax(iou, dim=1)
            rows = torch.arange(n, device=iou.device)
            masks_low = low_res[rows, best].reshape(b, k,
                                                    *low_res.shape[-2:])
            scores = iou[rows, best].reshape(b, k)
        else:
            # multimask unless cca mode (reference :522); best index 0
            low_res, iou = self.sam_model.decode(
                emb_rep, flat(coords), flat(labels),
                None if boxes is None else flat(boxes), None,
                not cfg.use_cca, boxes is None)
            masks_low = low_res[:, 0].reshape(b, k, *low_res.shape[-2:])
            scores = iou[:, 0].reshape(b, k)

        # postprocess: bilinear to the SAM frame (the pip predictor the
        # reference drives), then nearest to the query frame, composed
        size = (self.sam_model.image_size,) * 2
        masks = resize_bilinear_then_nearest(masks_low, size, original_size)
        summed = ((masks > 0.0) & valid[:, :, None, None]).any(dim=1).float()
        # an empty coarse prediction returns the coarse argmax (:612-613)
        empty = torch.amax(pred, dim=(1, 2)) == 0
        pred_out = resize_nearest(pred, original_size)
        out = torch.where(empty[:, None, None], pred_out, summed)
        scores = torch.where(empty[:, None], 0.0, scores * valid)
        return out, scores

    def forward_volume(self, queries: torch.Tensor,
                       coarse_model_input: ALPNetInput,
                       slice_batch: int = 8):
        """Segment a slice stack: queries (N, 3, H, W) -> (preds (N, H, W),
        scores (N, K)).  The support set is encoded once per volume; N is
        padded to a multiple of ``slice_batch``."""
        inp = coarse_model_input
        supp_fts = inp.supp_fts
        if supp_fts is None:
            with torch.no_grad():
                supp_fts = self.coarse_model.get_features(inp.supp_imgs)
        n = queries.shape[0]
        pad = (-n) % slice_batch
        if pad:
            queries = torch.cat([queries, queries[-1:].expand(pad, -1, -1,
                                                              -1)])
        preds, scores = [], []
        for i in range(0, queries.shape[0], slice_batch):
            p, s = self._forward_core(
                inp.supp_imgs, inp.fore_mask, inp.back_mask,
                queries[i:i + slice_batch], supp_fts, True, inp.val_wsize)
            preds.append(p)
            scores.append(s)
        return torch.cat(preds)[:n], torch.cat(scores)[:n]

    def forward(self, query_image: torch.Tensor,
                coarse_model_input: ALPNetInput, degrees_rotate: int = 0):
        """(pred (H, W), scores (K,)) for one query (1, 3, H, W) —
        reference ProtoSAM.forward.  ``degrees_rotate != 0`` takes the
        coarse logits from the rotated query (``_forward_rotated``)."""
        inp = coarse_model_input
        if degrees_rotate != 0:
            pred, scores = self._forward_rotated(query_image, inp,
                                                 degrees_rotate)
            return pred[0], scores[0]
        inp.set_query_images(query_image)
        pred, scores = self._forward_core(
            inp.supp_imgs, inp.fore_mask, inp.back_mask, inp.qry_imgs,
            inp.supp_fts, inp.isval, inp.val_wsize)
        return pred[0], scores[0]

    __call__ = forward
