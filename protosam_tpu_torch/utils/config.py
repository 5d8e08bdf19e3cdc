"""Experiment configuration — the reference's sacred config surface
(config_ssl_upload.py:32-168) as a plain dataclass with the same keys and
defaults, plus the sacred-style ``with key=value`` CLI override syntax so the
launch scripts map 1:1 (run_protosam.sh:99-123, backbone.sh:148-177).

The same ``Config`` as ``protosam_tpu.utils.config``, copied so that this
package needs no JAX: plain Python, the same fields and defaults, and the
same source snapshot of a run directory (``snapshot_sources``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Any

IMG_SIZE = 252               # reference util/consts.py:1
DEFAULT_FEATURE_SIZE = 32    # reference util/consts.py:2


def _f(default):
    return dataclasses.field(default_factory=lambda: default)


@dataclasses.dataclass
class Config:
    seed: int = 1234
    gpu_id: int = 0
    mode: str = "train"
    do_validation: bool = False
    num_workers: int = 4

    dataset: str = "CHAOST2_Superpix"
    use_coco_init: bool = True

    # training
    n_steps: int = 100100
    batch_size: int = 1
    lr_step_gamma: float = 0.95
    ignore_label: int = 255
    print_interval: int = 100
    save_snapshot_every: int = 25000
    max_iters_per_load: int = 1000
    epochs: int = 1
    scan_per_load: int = -1
    which_aug: str = "sabs_aug"
    input_size: tuple = (IMG_SIZE, IMG_SIZE)
    min_fg_data: str = "100"
    label_sets: int = 0
    curr_cls: str = ""
    exclude_cls_list: list = _f([2, 3])
    usealign: bool = True
    use_wce: bool = True
    use_dinov2_loss: bool = False
    dice_loss: bool = False

    # validation
    z_margin: int = 0
    eval_fold: int = 0
    support_idx: list = _f([-1])
    val_wsize: int = 2
    n_sup_part: int = 3
    use_clahe: bool = False
    debug: bool = False
    skip_no_organ_slices: bool = True

    # network
    modelname: str = "dlfcn_res101"
    clsname: str | None = None
    reload_model_path: str | None = None
    proto_grid_size: int = 8
    lora: int = 0
    use_3_slices: bool = False
    do_cca: bool = False
    finetune_on_support: bool = False
    online_finetuning: bool = True
    # accepted for launch-surface parity; these reference flags gate code
    # paths that are dead/unreachable in the reference itself (SURVEY.md §7)
    use_slice_adapter: bool = False
    adapter_layers: int = 3
    use_edge_detector: bool = False
    sliding_window_confidence_segmentation: bool = False
    finetune_model_on_single_slice: bool = False
    use_pos_enc: bool = False

    use_bbox: bool = True
    use_points: bool = True
    use_mask: bool = False
    base_model: str = "alpnet"

    superpix_scale: str = "MIDDLE"
    support_txt_file: str | None = None
    augment_support_set: bool = False
    coarse_pred_only: bool = False
    point_mode: str = "both"
    use_neg_points: bool = False
    n_support: int = 1
    protosam_sam_ver: str = "sam_h"
    grad_accumulation_steps: int = 1
    ttt: bool = False
    reset_after_slice: bool = True

    optim_type: str = "sgd"
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0005

    exp_prefix: str = ""
    log_dir: str = "./runs"
    data_dirs: dict = _f({
        "SABS": "./data/SABS/sabs_CT_normalized",
        "SABS_672": "./data/SABS/sabs_CT_normalized_672",
        "CHAOST2": "./data/CHAOST2/chaos_MR_T2_normalized/",
        "CHAOST2_672": "./data/CHAOST2/chaos_MR_T2_normalized_672/",
        "SABS_Superpix": "./data/SABS/sabs_CT_normalized",
        "CHAOST2_Superpix": "./data/CHAOST2/chaos_MR_T2_normalized/",
        "CHAOST2_Superpix_672": "./data/CHAOST2/chaos_MR_T2_normalized_672/",
        "SABS_Superpix_672": "./data/SABS/sabs_CT_normalized_672",
        "polyps": "./data/polyps",
    })

    # additions of this package and of protosam_tpu (no reference
    # counterpart)
    dtype: str = "bfloat16"
    slice_batch: int = 4
    max_ccs: int = 8
    use_fused_alp: bool = False   # fused ALP kernel K5 (inference only)
    # W8A8 int8 dense stages in both encoders (ops/quant.py, kernels K8 and
    # K9; inference only)
    quant_dense: bool = False

    @property
    def feature_hw(self) -> list[int]:
        if "dino" in self.modelname:
            side = max(self.input_size[0] // 14, DEFAULT_FEATURE_SIZE)
        else:
            side = -(-self.input_size[0] // 8)
        return [side, side]

    @property
    def task(self) -> dict:
        return {"n_ways": 1, "n_shots": 1, "n_queries": 1,
                "npart": self.n_sup_part}

    def data_dir(self, dataset: str | None = None) -> str:
        return self.data_dirs[dataset or self.dataset]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path):
        Path(path).write_text(json.dumps(self.to_dict(), indent=2,
                                         default=str))

    def snapshot_sources(self, log_dir: str | Path):
        """Sacred-style source capture (reference config_ssl_upload.py:26-30
        + FileStorageObserver): copy the entry script and record the repo
        revision into ``<log_dir>/_sources`` so a run is reproducible from
        its log directory alone."""
        import shutil
        import subprocess
        import sys

        dst = Path(log_dir) / "_sources"
        dst.mkdir(parents=True, exist_ok=True)
        main = sys.modules.get("__main__")
        main_file = getattr(main, "__file__", None)
        if main_file and Path(main_file).exists():
            shutil.copy2(main_file, dst / Path(main_file).name)
        repo = Path(__file__).resolve().parents[2]
        try:
            rev = subprocess.run(
                ["git", "-C", str(repo), "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=10).stdout.strip()
            dirty = subprocess.run(
                ["git", "-C", str(repo), "status", "--porcelain"],
                capture_output=True, text=True, timeout=10).stdout.strip()
            (dst / "REVISION").write_text(
                rev + (" (dirty)\n" if dirty else "\n"))
        except (OSError, subprocess.SubprocessError):
            pass


def parse_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse sacred-style ``with key=value ...`` CLI args (the reference's
    launch-script surface).  Values are Python literals when possible."""
    if argv and argv[0] == "with":
        argv = argv[1:]
    out: dict[str, Any] = {}
    for item in argv:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        k, v = item.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            low = v.strip()
            if low in ("True", "False"):
                out[k] = low == "True"
            elif low in ("None", "null"):
                out[k] = None
            else:
                out[k] = v
    return out


def load_config(argv: list[str] | None = None, **kwargs) -> Config:
    cfg = Config(**kwargs)
    if argv:
        for k, v in parse_overrides(argv).items():
            if k.startswith("path."):
                # sacred-style nested path overrides: path.log_dir=...,
                # path.<DATASET>.data_dir=...
                if k == "path.log_dir":
                    cfg.log_dir = v
                else:
                    parts = k.split(".")
                    if len(parts) == 3 and parts[2] == "data_dir":
                        cfg.data_dirs[parts[1]] = v
                continue
            if not hasattr(cfg, k):
                # tolerate reference-only keys (sacred passthroughs)
                continue
            cur = getattr(cfg, k)
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            setattr(cfg, k, v)
    return cfg
