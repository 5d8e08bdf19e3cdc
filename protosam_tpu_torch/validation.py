"""ALPNet-only evaluation on the card (the counterpart of the repo's
``validation.py``, with the same sacred-style surface):

    python3 -m protosam_tpu_torch.validation with modelname=dinov2_l14 \\
        dataset=CHAOST2 eval_fold=0 label_sets=0 support_idx=[4] \\
        "input_size=(672, 672)" do_cca=True ttt=True

``reload_model_path`` takes a ``.pth`` snapshot (the trainer's own
snapshots hold the state_dict under ``model``).
"""

from __future__ import annotations

import json
import logging
import sys

from protosam_tpu_torch.eval.alpnet_eval import run_alpnet_eval
from protosam_tpu_torch.utils.config import load_config


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    result = run_alpnet_eval(cfg)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
