"""Episodic self-supervised training on the card (the counterpart of the
repo's ``training.py``, with the same sacred-style surface):

    python3 -m protosam_tpu_torch.training with \\
        dataset=CHAOST2_Superpix modelname=dlfcn_res101 eval_fold=0 \\
        "exclude_cls_list=[2, 3]" n_steps=100100 path.log_dir=runs/train

Snapshots go to ``<log_dir>/snapshots`` and a rerun resumes from the
newest one.
"""

from __future__ import annotations

import logging
import sys

from protosam_tpu_torch.train.trainer import train
from protosam_tpu_torch.utils.config import load_config


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    out = train(cfg)
    print(f"training done at step {out['step']}")
    return out


if __name__ == "__main__":
    main()
