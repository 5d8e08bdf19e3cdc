"""ProtoMedSAM: coarse prototypes -> box prompts -> MedSAM (JAX
``pipeline/protomedsam.py``; reference models/ProtoMedSAM.py:10-249).

What differs from ProtoSAM:

  * the SAM input is the query min-max scaled to [0, 1] per slice over all
    channels: no uint8 floor, no SAM pixel normalisation (reference
    :204-205);
  * prompts are boxes only, zero points, one mask per prompt;
  * the sigmoid is taken on the low-res logits before the bilinear ->
    nearest resize, and the result thresholded at 0.5 (:31-65).

Batched over slices like ``ProtoSAM``.  Components are reduced with an
``any`` over the valid ones (the reference stacks them unreduced and is
only run in cca mode, one component); an empty coarse prediction returns
the coarse argmax as in ProtoSAM.
"""

from __future__ import annotations

import numpy as np
import torch

from protosam_tpu_torch.ops.cca import (component_confidences,
                                        connected_components)
from protosam_tpu_torch.ops.resize import (resize_bilinear,
                                           resize_bilinear_then_nearest,
                                           resize_nearest)
from protosam_tpu_torch.pipeline.protosam import (ProtoSAM, ProtoSAMConfig,
                                                  _keep_best_component)


class ProtoMedSAM(ProtoSAM):
    """ProtoSAM's construction and public API with the MedSAM forward."""

    def __init__(self, coarse_model, medsam_model,
                 config: ProtoSAMConfig | None = None):
        super().__init__(coarse_model, medsam_model,
                         config or ProtoSAMConfig(use_points=False,
                                                  use_bbox=True))

    def _extract_prompts(self, qrys, logits):
        """Box prompts and the [0, 1] MedSAM input for B slices."""
        cfg = self.config
        qimg = resize_bilinear(qrys, cfg.image_size)
        probs = torch.softmax(resize_bilinear(logits.float(),
                                              cfg.image_size), dim=1)
        pred = torch.argmax(probs, dim=1).float()              # (B, H, W)

        stats = connected_components(pred, cfg.max_ccs)
        conf = component_confidences(stats, probs[:, 1], pred)
        if cfg.use_cca:
            stats, conf = _keep_best_component(stats, conf)
        # boxes are already in the SAM frame (reference :199-202)
        boxes, valid = stats.bboxes.float(), stats.valid
        if cfg.use_cca:
            boxes, valid = boxes[:, :1], valid[:, :1]
        b, k = valid.shape

        lo = qimg.amin(dim=(1, 2, 3), keepdim=True)
        hi = qimg.amax(dim=(1, 2, 3), keepdim=True)
        return {"sam_image": (qimg - lo) / (hi - lo),
                "coords": qimg.new_zeros((b, k, 0, 2)),
                "labels": torch.zeros((b, k, 0), dtype=torch.int32,
                                      device=qimg.device),
                "boxes": boxes, "valid": valid, "pred": pred,
                "mask_inputs": None}

    def _decode_stage(self, emb, coords, labels, boxes, valid, pred,
                      original_size, mask_inputs=None):
        """Batched MedSAM decode over (B slices × K components): boxes
        only, one mask each, sigmoid > 0.5 (reference medsam_inference
        :31-65).  Returns (out (B, H, W), scores (B, K))."""
        cfg = self.config
        b, k = boxes.shape[:2]
        flat = lambda x: x.reshape((b * k,) + tuple(x.shape[2:]))
        low_res, iou = self.sam_model.decode(
            emb.repeat_interleave(k, dim=0), flat(coords), flat(labels),
            flat(boxes), None, False, False)
        prob = torch.sigmoid(low_res[:, 0].reshape(b, k,
                                                   *low_res.shape[-2:]))
        up = resize_bilinear_then_nearest(prob, cfg.image_size,
                                          original_size)
        seg = ((up > 0.5) & valid[:, :, None, None]).any(dim=1).float()

        empty = torch.amax(pred, dim=(1, 2)) == 0
        out = torch.where(empty[:, None, None],
                          resize_nearest(pred, original_size), seg)
        scores = torch.where(empty[:, None], 0.0,
                             iou[:, 0].reshape(b, k) * valid)
        return out, scores

    @torch.no_grad()
    def segment_all(self, query_image: torch.Tensor, query_label=None):
        """Whole-frame box oracle (reference :224-249): one box covering the
        query, three masks, and with a label the best of them against it,
        chosen on the host.  Returns (mask (H, W) float32 numpy, [score])."""
        h, w = query_image.shape[-2:]
        q = resize_bilinear(query_image, self.config.image_size)
        qn = (q - q.min()) / (q.max() - q.min())
        emb = self.sam_model.encode_image(qn[:1])
        dev = emb.device
        boxes = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=dev)
        low_res, iou = self.sam_model.decode(
            emb, torch.zeros((1, 0, 2), device=dev),
            torch.zeros((1, 0), dtype=torch.int32, device=dev), boxes,
            None, True, False)
        prob = torch.sigmoid(low_res[0])
        masks = (resize_bilinear(prob[:, None], (h, w))[:, 0]
                 > 0.5).cpu().numpy()
        if query_label is None:
            return masks[0].astype(np.float32), [float(iou[0, 0])]
        gt = np.asarray(query_label).reshape(h, w)
        best, best_iou = masks[0], -1.0
        for m in masks:
            tp = np.logical_and(m, gt).sum()
            fp = np.logical_and(m, 1 - gt).sum()
            fn = np.logical_and(1 - m, gt).sum()
            i = tp / max(tp + fp + fn, 1)
            if i > best_iou:
                best, best_iou = m, i
        return best.astype(np.float32), [best_iou]
