"""Plain float32 reference of the ProtoSAM slice pipeline around the two
encoders (``benchmark/families/``) and SAM's decoder (``models.py``),
written from the ProtoSAM description (arXiv:2407.07042; its
``models/ProtoSAM.py``, ``models/alpmodule.py`` and
``models/grid_proto_fewshot.py``) and the ``F.interpolate`` conventions it
calls:

* the coarse ALPNet head: the encoder's patch features as a grid
  (bilinearly upsampled to at least 32²), masks resized by legacy
  nearest, a background score from local grid prototypes and a foreground
  score from grid plus global prototypes, falling back to the global
  prototype when no pooled cell of the training window clears 0.95, the
  2-class map upsampled bilinearly to the image;
* the prompts: the logits upsampled to the SAM frame, softmax, argmax,
  8-connected components (``scipy.ndimage.label``, raster order), the most
  confident component kept, its most confident pixel, its centroid and its
  box;
* SAM's input: the query upsampled, min-max to uint8 steps (floored),
  normalised by SAM's pixel mean and std;
* the output: the low-res mask logits bilinearly to the SAM frame, then
  nearest to the query frame, thresholded at 0; an empty coarse mask returns
  the coarse argmax.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from benchmark.reference import models

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MIN_FEATURE = 32
THRESH = 0.95


def bilinear(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Legacy nearest of (..., H, W)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]).float(),
                      size=tuple(size), mode="nearest")
    return y.reshape(*lead, *y.shape[-2:]).to(x.dtype)


# ------------------------------------------------------------------ coarse


def coarse_features(encode, imgs: torch.Tensor, cfg: dict) -> torch.Tensor:
    """imgs (B, 3, H, W) -> (B, C, g, g) f32 patch features; ``encode``
    is the coarse encoder's family forward (patch tokens (B, g², C)),
    ``cfg`` the configuration's ``coarse`` section."""
    patch = cfg["patch_size"]
    side = cfg["input_size"] // patch * patch
    x = bilinear(imgs, (side, side))
    tok = encode(x)
    g = side // patch
    fts = tok.reshape(tok.shape[0], g, g, -1).permute(0, 3, 1, 2)
    if g < MIN_FEATURE:
        fts = bilinear(fts, (MIN_FEATURE, MIN_FEATURE))
    return fts


def _unit(x, dim):
    return x / torch.sqrt(torch.clamp((x * x).sum(dim, keepdim=True),
                                      min=1e-8))


def _match(q, protos, valid):
    """sum over valid prototypes of softmax(20 cos) * 20 cos."""
    d = 20.0 * torch.einsum("nchw,pc->nphw", _unit(q, 1), _unit(protos, 1))
    d = d[:, valid]
    if d.shape[1] == 0:
        return q.new_zeros(q.shape[0], 1, *q.shape[-2:])
    return (torch.softmax(d, dim=1) * d).sum(1, keepdim=True)


def _grid(fts, mask, window):
    pooled = F.avg_pool2d(fts, window)
    pm = F.avg_pool2d(mask, window)
    protos = pooled.flatten(2).transpose(1, 2).reshape(-1, fts.shape[1])
    return protos, pm.reshape(-1) > THRESH


def _global(fts, mask):
    return (fts * mask).sum((2, 3)) / (mask.sum((2, 3)) + 1e-5)


def coarse_scores(qry: torch.Tensor, supp: torch.Tensor, fg: torch.Tensor,
                  cfg: dict, window: int = 2,
                  dtype=torch.float32) -> torch.Tensor:
    """qry (N, C, h, w), supp (S, C, h, w), fg (S, H, W) -> raw scores
    (N, 2, h, w), float32 out; ``dtype`` is the computation's (float32;
    bfloat16 for the control)."""
    qry, supp = qry.to(dtype), supp.to(dtype)
    hw = tuple(supp.shape[-2:])
    fg_m = nearest(fg.to(dtype), hw)[:, None]
    bg_m = nearest(1.0 - fg.to(dtype), hw)[:, None]
    protos, valid = _grid(supp, bg_m, window)
    bg_score = _match(qry, protos, valid)
    fallback_window = hw[0] // cfg["proto_grid"]
    fg_scores = []
    for i in range(supp.shape[0]):
        s, m = supp[i:i + 1], fg_m[i:i + 1]
        if F.avg_pool2d(m, fallback_window).max() >= THRESH:
            protos, valid = _grid(s, m, window)
            glb = _global(s, m)
            fg_scores.append(_match(
                qry, torch.cat([protos, glb]),
                torch.cat([valid, torch.ones(1, dtype=torch.bool,
                                             device=valid.device)])))
        else:
            glb = _global(s, m)
            cos = torch.einsum("nchw,c->nhw", qry, glb[0]) / (
                torch.clamp(qry.norm(dim=1), min=1e-4)
                * torch.clamp(glb[0].norm(), min=1e-4))
            fg_scores.append(20.0 * cos[:, None])
    fg_score = torch.stack(fg_scores).amax(0)
    return torch.cat([bg_score, fg_score], dim=1).float()


# ----------------------------------------------------------------- prompts


def prompts(logits: torch.Tensor, sam_size: int, max_ccs: int = 8,
            dtype=torch.float32) -> dict:
    """Coarse logits (N, 2, H, W) -> the prompts of the most confident
    component of each slice: ``point`` (N, 2) xy, ``centroid`` (N, 2),
    ``box`` (N, 4) xyxy, ``valid`` (N,) bool, ``pred`` (N, S, S) the
    coarse argmax in the SAM frame.  ``dtype`` is the upsample's and the
    softmax's (float32; bfloat16 for the control)."""
    probs = torch.softmax(bilinear(logits.to(dtype), (sam_size, sam_size)),
                          dim=1)
    pred = torch.argmax(probs, dim=1)
    fg = probs[:, 1].double().cpu().numpy()
    pred_np = pred.cpu().numpy().astype(np.int32)
    n = pred_np.shape[0]
    point = np.zeros((n, 2))
    centroid = np.zeros((n, 2))
    box = np.zeros((n, 4))
    valid = np.zeros(n, bool)
    for i in range(n):
        lab, count = scipy.ndimage.label(pred_np[i], np.ones((3, 3), int))
        count = min(count, max_ccs)
        if count == 0:
            continue
        den = pred_np[i].sum() + 1e-6
        conf = [fg[i][lab == j].sum() / den for j in range(1, count + 1)]
        best = int(np.argmax(conf)) + 1
        if conf[best - 1] <= 0:
            continue
        region = lab == best
        ys, xs = np.nonzero(region)
        flat = np.where(region, fg[i], -np.inf).reshape(-1)
        top = int(np.argmax(flat))
        w = region.shape[1]
        point[i] = (top % w, top // w)
        centroid[i] = (xs.mean(), ys.mean())
        box[i] = (xs.min(), ys.min(), xs.max(), ys.max())
        valid[i] = True
    dev = logits.device
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return {"point": as_t(point), "centroid": as_t(centroid),
            "box": as_t(box), "valid": torch.as_tensor(valid, device=dev),
            "pred": pred.float()}


def sam_input(qrys: torch.Tensor, sam_size: int) -> torch.Tensor:
    """The query slices as SAM's encoder takes them."""
    q = bilinear(qrys.float(), (sam_size, sam_size))
    lo = q.amin(dim=(1, 2, 3), keepdim=True)
    hi = q.amax(dim=(1, 2, 3), keepdim=True)
    q = torch.floor((q - lo) / (hi - lo) * 255.0)
    mean = torch.tensor(PIXEL_MEAN, device=q.device).reshape(1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD, device=q.device).reshape(1, 3, 1, 1)
    return (q - mean) / std


def decode(w_sam: dict, emb: torch.Tensor, pr: dict, sam_size: int,
           dtype=torch.float32):
    """Box plus both points of each slice -> (low-res logits (N, 1, 4g, 4g),
    iou (N, 1)), float32 out; ``dtype`` is the computation's (float32;
    bfloat16 for the control)."""
    w = {k: v.to(dtype) for k, v in w_sam.items()
         if k.startswith(("prompt_encoder.", "mask_decoder."))}
    coords = torch.stack([pr["point"], pr["centroid"]], dim=1).to(dtype)
    labels = torch.where(pr["valid"][:, None], 1, -1).expand(-1, 2)
    grid = emb.shape[-1]
    sparse, dense = models.sam_prompt_embeddings(
        w, coords, labels, pr["box"].to(dtype), sam_size, grid)
    low, iou = models.sam_decode(w, emb.to(dtype), sparse, dense)
    return low.float(), iou.float()


def postprocess(low: torch.Tensor, iou: torch.Tensor, pr: dict,
                sam_size: int, out_size, dtype=torch.float32
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (masks (N, H, W) float 0/1, scores (N, 1))."""
    up = bilinear(low[:, :1].to(dtype), (sam_size, sam_size))
    masks = (nearest(up, out_size)[:, 0] > 0.0) & pr["valid"][:, None, None]
    empty = pr["pred"].amax(dim=(1, 2)) == 0
    coarse = nearest(pr["pred"], out_size)
    out = torch.where(empty[:, None, None], coarse, masks.float())
    scores = torch.where(empty[:, None], 0.0, iou * pr["valid"][:, None])
    return out, scores
