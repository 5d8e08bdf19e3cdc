"""Run the port's evaluation and compare its masks against recorded
reference masks: the counterpart of ``tools/run_agreement.py``.

    python3 -m protosam_tpu_torch.tools.run_agreement --ref-masks DIR \\
        [--device cuda] with modelname=dinov2_l14 dataset=CHAOST2 \\
        curr_cls=rk ... reload_model_path=alpnet.pth

``run_eval`` runs with its per-slice metric function hooked, so each
scored slice's predicted mask is saved as ``<log_dir>/our_masks/
slice_00000.npy`` (in scoring order, JAX's file names); then the
dice-agreement report against ``--ref-masks`` is printed.  Exits 0 only
when the report passes (overall Dice >= 0.99, BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

import protosam_tpu_torch.eval.protosam_eval as pe
from protosam_tpu_torch.utils.agreement import dice_agreement_report
from protosam_tpu_torch.utils.config import Config, load_config


def run_and_dump(cfg: Config, out_dir: str, pipe=None) -> dict:
    """``run_eval(cfg, pipe)`` with every scored slice's predicted mask
    written to ``out_dir/slice_<i>.npy``; returns run_eval's result."""
    os.makedirs(out_dir, exist_ok=True)
    orig_metric = pe.dice_iou_precision_recall
    count = 0

    def dump_and_score(pred, gt):
        nonlocal count
        np.save(os.path.join(out_dir, f"slice_{count:05d}.npy"),
                np.asarray(pred))
        count += 1
        return orig_metric(pred, gt)

    pe.dice_iou_precision_recall = dump_and_score
    try:
        return pe.run_eval(cfg, pipe=pipe)
    finally:
        pe.dice_iou_precision_recall = orig_metric


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-masks", required=True)
    ap.add_argument("--device", default="cuda",
                    help="where the models run (the card by default)")
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    cfg = load_config(args.rest)
    ours_dir = os.path.join(cfg.log_dir or ".", "our_masks")
    run_and_dump(cfg, ours_dir, pe.build_models(cfg, device=args.device))
    report = dice_agreement_report(ours_dir, args.ref_masks, pattern="*.npy")
    print(json.dumps(report, indent=2))
    return 0 if report["passes_099"] else 1


if __name__ == "__main__":
    sys.exit(main())
