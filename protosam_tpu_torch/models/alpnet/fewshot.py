"""ALPNet few-shot coarse segmenter (reference models/grid_proto_fewshot.py
FewShotSeg:25-290), DINOv2 or DeepLab ResNet-101 backbones.

One encoder pass over [support..., query], masks resized to the feature grid
(nearest), a BG 'gridconv' pass over all shots jointly, per-shot FG
'gridconv+' passes (max over shots) with the fallback to 'mask' mode, and a
bilinear upsample of the 2-class score map to image size.  Scoring and the
upsample run in f32: their argmax seeds CCA and every SAM prompt.
``use_fused_alp`` routes the BG and the per-shot FG matching through kernel
K5 (JAX ``fewshot.py:53,129-137``).  ``quant_dense`` makes DINOv2's dense
stages int8 (JAX ``fewshot.py:54-56,79``); the f32 coarse-logit tail is
never quantized.  ``align_loss`` is the training-time PANet alignment
loss (JAX ``fewshot.py:177-215``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from protosam_tpu_torch.models.backbones.resnet import (
    PUBLISHED_LAYERS, PUBLISHED_WIDTHS, DeeplabRes101Encoder)
from protosam_tpu_torch.models.dinov2.vit import build_dinov2
from protosam_tpu_torch.ops.alp import alp_score, fg_score_with_fallback
from protosam_tpu_torch.ops.resize import resize_bilinear, resize_nearest

DEFAULT_FEATURE_SIZE = 32  # reference util/consts.py:2
FG_THRESH = 0.95           # reference grid_proto_fewshot.py:21-22
BG_THRESH = 0.95

# (layers, widths) of each ResNet name; ``dlfcn_res_t`` is a test-size
# variant (every dilation of the published trunk, an eighth of its widths)
_RESNET = {
    "dlfcn_res101": (PUBLISHED_LAYERS, PUBLISHED_WIDTHS),
    "default": (PUBLISHED_LAYERS, PUBLISHED_WIDTHS),
    "dlfcn_res_t": ((1, 1, 2, 2), (8, 16, 32, 64)),
}
_ENCODER_ALIASES = {
    "dlfcn_res101": "dlfcn_res101",
    "default": "dlfcn_res101",
    "dlfcn_res_t": "dlfcn_res_t",
    "dinov2_l14": "dinov2_vitl14",
    "dinov2_l14_reg": "dinov2_vitl14_reg",
    "dinov2_b14": "dinov2_vitb14",
    "dinov2_s14": "dinov2_vits14",
    "dinov2_g14": "dinov2_vitg14",
    "dinov2_t14": "dinov2_vitt14",
    "dinov2_gt14": "dinov2_vitgt14",
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
        if which_model in _RESNET:
            self.encoder = DeeplabRes101Encoder(*_RESNET[which_model])
        else:
            self.encoder = build_dinov2(_ENCODER_ALIASES[which_model],
                                        quant_dense=quant_dense)

    @property
    def feature_hw(self) -> int:
        if self.which_model in _RESNET:
            return math.ceil(self.image_size / 8)
        return max(self.image_size // 14, DEFAULT_FEATURE_SIZE)

    @property
    def kernel_size(self) -> int:
        """Training-time pooling window (reference alpmodule.py:34-37), also
        the window of the FG fallback check."""
        return self.feature_hw // self.proto_grid_size

    def get_features(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs (B, 3, H, W) -> f32 features (B, C, h, w): resize to a
        multiple of 14, patch tokens as an (h, w) grid, upsampled to at
        least 32² (reference grid_proto_fewshot.py:83-103).  The ResNet
        takes the images as they are (output stride 8)."""
        if self.which_model in _RESNET:
            return self.encoder(imgs)
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

    def align_loss(self, qry_fts: torch.Tensor, pred: torch.Tensor,
                   supp_fts: torch.Tensor, fore_mask: torch.Tensor,
                   back_mask: torch.Tensor, val_wsize: int) -> torch.Tensor:
        """PANet prototype-alignment loss (reference
        grid_proto_fewshot.py:293-375; JAX ``fewshot.py:177-215``): the
        query's predicted fg/bg masks, resized bilinearly to the feature
        grid, pool prototypes from the query features, which then score
        each support image against its label (1 fg, 0 bg, 255 ignored).

        qry_fts (1, C, h, w); pred (1, 2, H', W') scores; supp_fts (S, C,
        h, w); fore/back_mask (S, H, W).  Returns the sum over shots of
        each shot's mean NLL / S."""
        s = supp_fts.shape[0]
        hw = tuple(qry_fts.shape[-2:])
        qry_fts = qry_fts.float()
        pred_cls = torch.argmax(pred, dim=1)                   # (1, H', W')
        qry_bg = resize_bilinear((pred_cls == 0).float()[None], hw)[0]
        qry_fg = resize_bilinear((pred_cls == 1).float()[None], hw)[0]
        loss = qry_fts.new_zeros(())
        for i in range(s):
            supp_ft = supp_fts[i:i + 1].float()
            bg_score = alp_score(supp_ft, qry_fts, qry_bg[:, None],
                                 "gridconv", val_wsize, BG_THRESH)
            fg_score = fg_score_with_fallback(
                supp_ft, qry_fts, qry_fg[:, None], window=val_wsize,
                fallback_window=4, thresh=FG_THRESH)
            sp = resize_bilinear(torch.cat([bg_score, fg_score], dim=1),
                                 tuple(fore_mask.shape[-2:]))
            label = torch.where(fore_mask[i] == 1, 1,
                                torch.where(back_mask[i] == 1, 0, 255))
            logp = torch.log_softmax(sp[0], dim=0)
            picked = torch.gather(logp, 0,
                                  label.clamp(0, 1)[None].long())[0]
            picked = torch.where(label == 255, 0.0, picked)
            denom = torch.clamp((label != 255).sum(), min=1)
            loss = loss - picked.sum() / denom / s
        return loss
