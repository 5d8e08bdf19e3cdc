"""ProtoSAM evaluation: the models of an experiment ``Config`` (JAX
``eval/protosam_eval.py:37-94``).

``build_models(cfg, device="cuda")`` maps the eval configuration to the pipeline
and its ``ProtoSAMConfig``, with seeded synthetic weights from
``cfg.seed``.  The evaluation loop (``run_eval``) and the data layer are
not ported yet (ROADMAP §1 item 13).
"""

from __future__ import annotations

import torch

from protosam_tpu_torch.entry import build_pipeline
from protosam_tpu_torch.pipeline.protosam import ProtoSAM, ProtoSAMConfig
from protosam_tpu_torch.utils.config import Config

SAM_VERSIONS = {"sam_h": "vit_h", "sam_b": "vit_b", "sam_l": "vit_l",
                "vit_h": "vit_h", "vit_b": "vit_b", "vit_t": "vit_t",
                "medsam": "vit_b"}
SAM_IMAGE_SIZE = 1024


def build_models(cfg: Config, device: torch.device | str = "cuda",
                 fused_mlp: bool = False,
                 fused_proj: bool = False) -> ProtoSAM:
    """The ProtoSAM pipeline of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU).

    ``cfg.use_fused_alp`` puts the ALP matching on kernel K5,
    ``cfg.quant_dense`` both encoders' dense stages on the int8 path
    (kernels K8 and K9, which turns the two SAM routes off).  The SAM
    encoder routes come from ``fused_mlp`` / ``fused_proj`` (kernels K7 /
    K6, bf16 only), which the JAX package reads from ``PTPU_MLP_PALLAS`` /
    ``PTPU_PROJ_PALLAS``."""
    if cfg.protosam_sam_ver == "medsam":
        raise NotImplementedError("ProtoMedSAM is not ported yet "
                                  "(ROADMAP §1 item 11)")
    if cfg.reload_model_path:
        raise NotImplementedError("checkpoint loading is not ported yet "
                                  "(ROADMAP §1 item 12)")
    pconf = ProtoSAMConfig(
        image_size=(SAM_IMAGE_SIZE, SAM_IMAGE_SIZE),
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
    return build_pipeline(
        device, sam_ver=SAM_VERSIONS[cfg.protosam_sam_ver],
        coarse=cfg.modelname, image_size=cfg.input_size[0],
        sam_size=SAM_IMAGE_SIZE, dtype=dtype, config=pconf, seed=cfg.seed,
        proto_grid_size=cfg.proto_grid_size,
        use_fused_alp=cfg.use_fused_alp, fused_mlp=fused_mlp,
        fused_proj=fused_proj, quant_dense=cfg.quant_dense)
