"""ALPNet few-shot coarse segmenter (reference models/grid_proto_fewshot.py
FewShotSeg:25-290), DINOv2 backbones.

One encoder pass over [support..., query], masks resized to the feature grid
(nearest), a BG 'gridconv' pass over all shots jointly, per-shot FG
'gridconv+' passes (max over shots) with the fallback to 'mask' mode, and a
bilinear upsample of the 2-class score map to image size.  Scoring and the
upsample run in f32: their argmax seeds CCA and every SAM prompt.
``use_fused_alp`` routes the BG and the per-shot FG matching through kernel
K5 (JAX ``fewshot.py:53,129-137``).  ``quant_dense`` makes DINOv2's dense
stages int8 (JAX ``fewshot.py:54-56,79``); the f32 coarse-logit tail is
never quantized.
"""

from __future__ import annotations

import torch
from torch import nn

from protosam_tpu_torch.models.dinov2.vit import build_dinov2
from protosam_tpu_torch.ops.alp import alp_score, fg_score_with_fallback
from protosam_tpu_torch.ops.resize import resize_bilinear, resize_nearest

DEFAULT_FEATURE_SIZE = 32  # reference util/consts.py:2
FG_THRESH = 0.95           # reference grid_proto_fewshot.py:21-22
BG_THRESH = 0.95

_ENCODER_ALIASES = {
    "dinov2_l14": "dinov2_vitl14",
    "dinov2_l14_reg": "dinov2_vitl14_reg",
    "dinov2_b14": "dinov2_vitb14",
    "dinov2_s14": "dinov2_vits14",
    "dinov2_t14": "dinov2_vitt14",
}


class FewShotSeg(nn.Module):
    def __init__(self, image_size: int = 672,
                 which_model: str = "dinov2_l14", proto_grid_size: int = 8,
                 use_fused_alp: bool = False, quant_dense: bool = False):
        super().__init__()
        if which_model not in _ENCODER_ALIASES:
            raise KeyError(f"unsupported coarse backbone {which_model!r}; "
                           f"have {sorted(_ENCODER_ALIASES)}")
        self.image_size = image_size
        self.which_model = which_model
        self.proto_grid_size = proto_grid_size
        self.use_fused_alp = use_fused_alp
        self.encoder = build_dinov2(_ENCODER_ALIASES[which_model],
                                    quant_dense=quant_dense)

    @property
    def feature_hw(self) -> int:
        return max(self.image_size // 14, DEFAULT_FEATURE_SIZE)

    @property
    def kernel_size(self) -> int:
        """Training-time pooling window (reference alpmodule.py:34-37), also
        the window of the FG fallback check."""
        return self.feature_hw // self.proto_grid_size

    def get_features(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs (B, 3, H, W) -> f32 features (B, C, h, w): resize to a
        multiple of 14, patch tokens as an (h, w) grid, upsampled to at
        least 32² (reference grid_proto_fewshot.py:83-103)."""
        side = self.image_size // 14 * 14
        x = resize_bilinear(imgs, (side, side))
        tokens = self.encoder(x)["x_norm_patchtokens"]        # (B, N, C)
        g = side // 14
        fts = tokens.reshape(tokens.shape[0], g, g, -1).permute(0, 3, 1, 2)
        if g < DEFAULT_FEATURE_SIZE:
            fts = resize_bilinear(fts, (DEFAULT_FEATURE_SIZE,) * 2)
        return fts

    def score(self, qry_fts: torch.Tensor, supp_fts: torch.Tensor,
              fore_mask: torch.Tensor, back_mask: torch.Tensor,
              val_wsize: int) -> torch.Tensor:
        """qry_fts (N, C, h, w); supp_fts (S, C, h, w); masks (S, h, w) at
        feature resolution.  Returns (N, 2, h, w) raw f32 scores."""
        qry_fts, supp_fts = qry_fts.float(), supp_fts.float()
        bg = back_mask[:, None].float()
        bg_score = alp_score(qry_fts, supp_fts, bg, "gridconv", val_wsize,
                             BG_THRESH, self.use_fused_alp)
        fg_scores = [fg_score_with_fallback(
            qry_fts, supp_fts[i:i + 1], fore_mask[i:i + 1, None].float(),
            window=val_wsize, fallback_window=self.kernel_size,
            thresh=FG_THRESH, use_fused=self.use_fused_alp)
            for i in range(supp_fts.shape[0])]
        fg_score = torch.amax(torch.stack(fg_scores), dim=0)  # max over shots
        return torch.cat([bg_score, fg_score], dim=1)

    def forward(self, supp_imgs: torch.Tensor, fore_mask: torch.Tensor,
                back_mask: torch.Tensor, qry_imgs: torch.Tensor,
                isval: bool = True, val_wsize: int = 2,
                supp_fts: torch.Tensor | None = None) -> dict:
        """supp_imgs (S, 3, H, W); fore/back_mask (S, H, W); qry_imgs
        (N, 3, H, W).  Returns logits (N, 2, H, W), supp_fts, qry_fts."""
        s = supp_imgs.shape[0]
        window = val_wsize if isval else self.kernel_size
        if supp_fts is None:
            fts = self.get_features(torch.cat([supp_imgs, qry_imgs]))
            supp_fts, qry_fts = fts[:s], fts[s:]
        else:
            qry_fts = self.get_features(qry_imgs)
        hw = tuple(supp_fts.shape[-2:])
        res_fg = resize_nearest(fore_mask.float(), hw)
        res_bg = resize_nearest(back_mask.float(), hw)
        pred = self.score(qry_fts, supp_fts, res_fg, res_bg, window)
        logits = resize_bilinear(pred, tuple(supp_imgs.shape[-2:]))
        return {"logits": logits, "supp_fts": supp_fts, "qry_fts": qry_fts}
