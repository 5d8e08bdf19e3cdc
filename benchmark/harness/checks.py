"""What decides ``correct``: the outputs of the timed path, held to the
plain float32 reference (``benchmark/reference``) once the window has
closed and the program has been freed.

The program's outputs come from the sampled calls of the window (``Probe``
captures): per batch the coarse scores, the prompts, the SAM image
embedding, the low-res mask logits and IoU scores, and per volume the
masks and scores ``forward_volume`` returned.  The reference computes the
two encoders' outputs from the same inputs and weights; the float32 stages
follow the program's own state: ALP reads the program's features, the
prompt stage the program's coarse scores (their argmax decides every
prompt, so a reference fed its own scores would judge other prompts), the
decoder and the post-resize the program's embedding and prompts.  Each
hand-over is itself a compared number.

Numbers, each the worst over the sampled slices:

* ``feat_nsr``: the noise-to-signal power of DINOv2's features (support
  and queries) over all sampled slices, Σ‖program − reference‖² /
  Σ‖reference‖² (the bf16 encoders' rounding is noise of about 1.4% in
  amplitude; the int8 control's 2.2-2.3 times that, 5 times in power);
* ``alp_gap``: ‖program − reference‖ / ‖reference‖ of a slice's coarse
  scores, the reference's ALP reading the program's features;
* ``embed_nsr``: the SAM image embedding, as ``feat_nsr``;
* ``prompt_px``: the largest gap in pixels of a point, centroid or box
  corner (1e6 where the two disagree on whether there is a component);
* ``logit_gap``: as ``alp_gap``, of the low-res mask logits (slices with
  a component);
* ``score_gap``: the largest gap of a predicted IoU score;
* ``mask_gap``: 1 − Dice of a slice's final mask against the reference's
  (0 where both are empty);
* for the evaluation, ``data_gap``: the largest gap of a query or support
  pixel or support-mask value the data layer built, against the
  reference's reading of the files; ``metric_gap``: the largest gap of
  the mean Dice, IoU, precision or recall ``run_eval`` returned, against
  the reference's scores of the program's own masks.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import family, weights
from benchmark.harness.synth import FOLD_NAMES
from benchmark.reference import data as rdata
from benchmark.reference import models
from benchmark.reference import pipeline as rp

MISMATCH = 1e6


def _power(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Σ‖p − r‖², Σ‖r‖²) over the rows of (N, ...) tensors."""
    p, r = p.float().flatten(1), r.float().flatten(1)
    return torch.stack([((p - r) ** 2).sum(), (r ** 2).sum()])


def _rel(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 gap of (N, ...) tensors."""
    p, r = p.float().flatten(1), r.float().flatten(1)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)


def _dice_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.flatten(1).float(), b.flatten(1).float()
    inter = (a * b).sum(1)
    tot = a.sum(1) + b.sum(1)
    return torch.where(tot > 0, 1.0 - 2.0 * inter / tot.clamp(min=1), 0.0)


class Reference:
    """The reference's weights of one seed (float32, on the device) and
    the encoders' families (``harness/family.py``) of the configuration."""

    def __init__(self, cfg: dict, seed: int, device, root=family.ROOT):
        self.cfg = cfg
        wc, self.sam = weights.state_dicts(cfg, seed, device, root)
        self.coarse = weights.strip(wc, "encoder.")
        self.coarse_family = family.load(cfg["coarse"], root)
        self.sam_family = family.load(cfg["sam"], root)

    def features(self, imgs):
        c = self.cfg["coarse"]
        return rp.coarse_features(
            lambda x: self.coarse_family.forward(self.coarse, x, c),
            imgs.float(), c)

    def embedding(self, qrys):
        s = self.cfg["sam"]
        return self.sam_family.forward(
            self.sam, rp.sam_input(qrys, s["image_size"]), s)


def _cat(batches, n):
    return torch.cat(batches)[:n]


def volume_readings(ref: Reference, queries, support, support_mask,
                    capture: dict, preds, scores, block: int = 4,
                    lower: bool = False) -> dict:
    """The stage gaps of one ``forward_volume`` call of ``n`` slices.
    ``lower`` is the control of the float32 stages' numbers: the
    reference's prompts from bfloat16 scores, upsample and softmax, and
    its decoder and post-resize in bfloat16, put in the program's place."""
    cfg = ref.cfg
    n = queries.shape[0]
    sam_size = cfg["sam"]["image_size"]
    out_size = tuple(queries.shape[-2:])
    max_ccs = cfg["pipeline"]["max_ccs"]
    feats = capture["get_features"]
    p_sfts, p_fts = feats[0], _cat(feats[1:], n)
    p_scores = _cat(capture["score"], n)
    p_emb = _cat(capture["encode_image"], n)
    pr_b = capture["_extract_prompts"]
    coords = _cat([p["coords"][:, 0] for p in pr_b], n)
    p_box = _cat([p["boxes"][:, 0] for p in pr_b], n)
    p_valid = _cat([p["valid"][:, 0] for p in pr_b], n)
    p_low = _cat([d[0][:, :1] for d in capture["decode"]], n)
    p_iou = _cat([d[1][:, :1] for d in capture["decode"]], n)
    gaps = {k: [] for k in ("feat_nsr", "alp_gap", "embed_nsr", "prompt_px",
                            "logit_gap", "score_gap", "mask_gap")}
    dt = torch.bfloat16 if lower else torch.float32
    with models.no_tf32(), torch.no_grad():
        gaps["feat_nsr"].append(_power(p_sfts, ref.features(support)))
        for lo in range(0, n, block):
            sl = slice(lo, min(n, lo + block))
            q = queries[sl]
            # the encoders, from the inputs
            gaps["feat_nsr"].append(_power(p_fts[sl], ref.features(q)))
            gaps["embed_nsr"].append(_power(p_emb[sl], ref.embedding(q)))
            # ALP, from the program's features
            r_scores = rp.coarse_scores(p_fts[sl], p_sfts, support_mask,
                                        cfg["coarse"])
            c_scores = rp.coarse_scores(p_fts[sl], p_sfts, support_mask,
                                        cfg["coarse"], dtype=dt) if lower \
                else p_scores[sl]
            gaps["alp_gap"].append(_rel(c_scores, r_scores))
            # the prompts, from the program's coarse scores
            logits = rp.bilinear(p_scores[sl].float(), out_size)
            pr = rp.prompts(logits, sam_size, max_ccs)
            pr_p = {"point": coords[sl, 0], "centroid": coords[sl, 1],
                    "box": p_box[sl], "valid": p_valid[sl],
                    "pred": pr["pred"]}
            if lower:
                low_pr = rp.prompts(rp.bilinear(
                    p_scores[sl].to(dt), out_size), sam_size, max_ccs, dt)
                pr_p.update({k: low_pr[k] for k in ("point", "centroid",
                                                    "box", "valid")})
            same = pr["valid"] == pr_p["valid"]
            px = torch.stack([
                (pr["point"] - pr_p["point"]).abs().amax(1),
                (pr["centroid"] - pr_p["centroid"]).abs().amax(1),
                (pr["box"] - pr_p["box"]).abs().amax(1)]).amax(0)
            px = torch.where(pr["valid"], px, 0.0)
            gaps["prompt_px"].append(torch.where(same, px, MISMATCH))
            # the decoder and the post-resize, from the program's
            # embedding and prompts
            emb = p_emb[sl].float()
            low, iou = rp.decode(ref.sam, emb, pr_p, sam_size)
            masks, r_sc = rp.postprocess(low, iou, pr_p, sam_size, out_size)
            if lower:
                c_low, c_iou = rp.decode(ref.sam, emb, pr_p, sam_size, dt)
                c_masks, c_sc = rp.postprocess(c_low, c_iou, pr_p, sam_size,
                                               out_size, dt)
            else:
                c_low, c_iou = p_low[sl], p_iou[sl]
                c_masks, c_sc = preds[sl], scores[sl]
            v = pr_p["valid"]
            gaps["logit_gap"].append(torch.where(v, _rel(c_low, low), 0.0))
            gaps["score_gap"].append(torch.where(
                v, (c_iou[:, 0] - iou[:, 0]).abs(), 0.0))
            gaps["score_gap"].append((c_sc[:, 0] - r_sc[:, 0]).abs())
            gaps["mask_gap"].append(_dice_gap(c_masks, masks))
    out = {k: float(torch.cat(v).max()) for k, v in gaps.items()
           if not k.endswith("_nsr")}
    for k in ("feat_nsr", "embed_nsr"):
        noise, signal = torch.stack(gaps[k]).sum(0)
        out[k] = float(noise / signal)
    return {k: out[k] for k in gaps}


def eval_readings(ref: Reference, mix: dict, fold_dir: str,
                  capture: dict, result: dict, lower: bool = False) -> dict:
    """The data, stage and metric gaps of one ``run_eval`` call.
    ``lower`` (the control of ``data_gap``, ``metric_gap`` and
    ``prompt_px``) puts the reference's own data rounded to bfloat16 and
    its float32 scores in the program's place."""
    fold = mix["fold"]
    ids = [str(i) for i in fold["scan_ids"]]
    cls = FOLD_NAMES.index(mix["label_name"])
    chunks = rdata.episode(fold_dir, ids, mix["support_idx"][0], cls,
                           mix["label_name"], mix["input_size"],
                           mix["n_sup_part"])
    calls = capture["forward_volume"]
    if len(calls) != len(chunks):
        return {"data_gap": MISMATCH, "metric_gap": MISMATCH}
    readings: dict[str, float] = {"data_gap": 0.0}
    preds, labels = [], []
    at = 0
    for chunk_i, (chunk, call) in enumerate(zip(chunks, calls)):
        dev = call["queries"].device
        for key, ours in (("queries", chunk["queries"]),
                          ("support", chunk["support"]),
                          ("support_mask", chunk["support_mask"])):
            theirs = call[key].float()
            if lower:
                theirs = torch.from_numpy(ours).to(dev).to(
                    torch.bfloat16).float()
            if tuple(theirs.shape) != ours.shape:
                readings["data_gap"] = MISMATCH
                continue
            gap = float((theirs - torch.from_numpy(ours).to(dev)).abs()
                        .max())
            readings["data_gap"] = max(readings["data_gap"], gap)
        n = call["queries"].shape[0]
        nb = -(-n // mix["slice_batch"])
        sub = {k: v[at:at + nb] for k, v in capture.items()
               if k not in ("forward_volume", "get_features")}
        # get_features: the chunk's support encode, then its batches
        sub["get_features"] = capture["get_features"][at + chunk_i:
                                                      at + chunk_i + nb + 1]
        at += nb
        r = volume_readings(ref, call["queries"], call["support"],
                            call["support_mask"], sub, call["preds"],
                            call["scores"], lower=lower)
        for k, v in r.items():
            readings[k] = max(readings.get(k, 0.0), v)
        preds += list(call["preds"].cpu().numpy())
        labels += list(chunk["labels"])
    ours = rdata.slice_scores(preds, labels)
    theirs = {"dice": result["mar_val_batches_meanDice"],
              "iou": result["mar_val_al_batches_meanIOU"],
              "precision": result["mar_val_batches_meanPrec"],
              "recall": result["mar_val_al_batches_meanRec"]}
    if lower:
        theirs = rdata.slice_scores(preds, labels, np.float32)
    readings["metric_gap"] = max(abs(ours[k] - theirs[k]) for k in ours)
    if len(preds) != result["n_slices"]:
        readings["metric_gap"] = MISMATCH
    return readings


def judge(readings: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, one line a number: its name, reading and limit).  A number
    with no limit is reported and not judged; a limit with no reading (no
    sampled call completed) fails."""
    ok, lines = True, []
    for name in limits:
        if name not in readings:
            ok = False
            lines.append(f"{name} missing limit {limits[name]!r}  FAILS")
    for name, value in readings.items():
        limit = limits.get(name)
        bad = limit is not None and not (np.isfinite(value)
                                         and value <= limit)
        ok &= not bad
        lines.append(f"{name} {value!r} limit {limit!r}"
                     + ("  FAILS" if bad else ""))
    return ok, lines
