"""ProtoSAM evaluation entry point on the card (the counterpart of the
repo's ``validation_protosam.py``, with the same sacred-style surface):

    python3 -m protosam_tpu_torch.validation_protosam with \\
        modelname=dinov2_l14 protosam_sam_ver=sam_h \\
        dataset=CHAOST2_Superpix_672 curr_cls=rk eval_fold=0 \\
        "input_size=(672, 672)" do_cca=True support_idx=[4]

Prints the result without its per-case table (which ``log_dir`` keeps).
"""

from __future__ import annotations

import json
import logging
import sys

from protosam_tpu_torch.eval.protosam_eval import run_eval
from protosam_tpu_torch.utils.config import load_config


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    result = run_eval(cfg)
    print(json.dumps({k: v for k, v in result.items() if k != "cases"},
                     indent=2))
    return result


if __name__ == "__main__":
    main()
