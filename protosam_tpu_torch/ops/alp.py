"""ALP (Adaptive Local Prototype) pooling and matching with static shapes.

The reference ``MultiProtoAsConv`` (models/alpmodule.py:21-198) gathers the
pooled grid cells whose pooled mask clears a threshold — a dynamic shape.
Here every pooled cell is kept with a validity mask; invalid cells are
masked out of the softmax-weighted sum (their weight underflows to exactly
0 and their term is zeroed), which equals the reference's gather.

Modes: ``mask`` (one global prototype per shot, cosine ×20, max over
shots), ``gridconv`` (local grid prototypes), ``gridconv+`` (grid plus the
per-shot global prototypes).  ``use_fused`` routes the grid modes' matching
through kernel K5 (``alp_match_fused``, ``csrc/alp.cu``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from protosam_tpu_torch import kernels
from protosam_tpu_torch.ops.norm import clamped_norm, safe_l2_normalize
from protosam_tpu_torch.ops.pooling import avg_pool2d

NEG_INF = -1e10
SIM_SCALE = 20.0
# prototypes per block of K5 (``kTP`` in csrc/alp.cu): the wrapper pads the
# prototype count to a multiple of it
ALP_SPLIT = 128


class Prototypes(NamedTuple):
    """protos (P, C) unnormalised; valid (P,) bool."""

    protos: torch.Tensor
    valid: torch.Tensor


def grid_prototypes(sup_fts: torch.Tensor, sup_mask: torch.Tensor,
                    window: int, thresh: float) -> Prototypes:
    """sup_fts (S, C, H, W), sup_mask (S, 1, H, W) -> P = S·(H/w)·(W/w)
    rows, row-major per shot; valid where the pooled mask > thresh."""
    s, c = sup_fts.shape[:2]
    pooled = avg_pool2d(sup_fts, window)
    pooled_mask = avg_pool2d(sup_mask, window)
    protos = pooled.reshape(s, c, -1).transpose(1, 2).reshape(-1, c)
    return Prototypes(protos, pooled_mask.reshape(-1) > thresh)


def global_prototypes(sup_fts: torch.Tensor,
                      sup_mask: torch.Tensor) -> torch.Tensor:
    """Per-shot masked average sum(x·y)/(sum(y)+1e-5) -> (S, C)."""
    num = torch.sum(sup_fts * sup_mask, dim=(-1, -2))
    den = torch.sum(sup_mask, dim=(-1, -2)) + 1e-5
    return num / den


def _match(qn: torch.Tensor, pn: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """sum over valid prototypes of softmax(20·qn·pn) · 20·qn·pn; invalid
    terms are zeroed, so an all-invalid pixel gives exactly 0."""
    dists = SIM_SCALE * torch.einsum("nchw,pc->nphw", qn, pn)
    valid = valid[None, :, None, None]
    w = torch.softmax(torch.where(valid, dists, NEG_INF), dim=1)
    return torch.sum(w * torch.where(valid, dists, 0.0), dim=1, keepdim=True)


def alp_match_fused_plain(qry_fts: torch.Tensor, protos: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """K5's plain version, with the TPU kernel's numerics
    (``alp_pallas.py:30-46``): the query normalised as
    x·rsqrt(max(|x|², 1e-8)), the prototypes by ``safe_l2_normalize``."""
    q = qry_fts.float()
    n2 = torch.sum(q * q, dim=1, keepdim=True)
    qn = q * torch.rsqrt(torch.clamp(n2, min=1e-8))
    return _match(qn, safe_l2_normalize(protos.float(), dim=1), valid)


def alp_match_fused(qry_fts: torch.Tensor, protos: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Fused ALP matching: qry_fts (N, C, H, W), protos (P, C) raw, valid
    (P,) bool -> (N, 1, H, W) f32.  Kernel K5 on a CUDA tensor, the plain
    version on a CPU tensor.  The prototypes are normalised here, outside
    the kernel, as the JAX wrapper does (``alp_pallas.py:69``), and handed
    over transposed, (C, P) zero-padded to whole ``ALP_SPLIT``-prototype
    splits, so both of the kernel's operands are contiguous along its tile
    rows; each split writes per-pixel softmax partials to a scratch that
    the kernel's combine pass merges.

    K5 has no backward, as JAX's kernel has no VJP (JAX training keeps the
    plain path, ``models/alpnet/fewshot.py:51-52``): under grad it raises
    rather than fall back."""
    if torch.is_grad_enabled() and (qry_fts.requires_grad
                                    or protos.requires_grad):
        raise RuntimeError("alp_match_fused has no backward: train with "
                           "use_fused_alp=False (the plain ALP path)")
    if qry_fts.device.type == "cpu":
        return alp_match_fused_plain(qry_fts, protos, valid)
    n, c, h, w = qry_fts.shape
    p = protos.shape[0]
    if protos.shape != (p, c) or valid.shape != (p,):
        raise ValueError(f"alp_match_fused: protos {tuple(protos.shape)} / "
                         f"valid {tuple(valid.shape)} do not fit C = {c}")
    splits = max(1, -(-p // ALP_SPLIT))
    pad = splits * ALP_SPLIT - p
    q = qry_fts.float().contiguous()
    pt = F.pad(safe_l2_normalize(protos.float(), dim=1).t(),
               (0, pad)).contiguous()
    v = F.pad(valid.to(torch.uint8), (0, pad)).contiguous()
    part = torch.empty((n, splits, 3, h * w), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((n, 1, h, w), dtype=torch.float32, device=q.device)
    dev = kernels.check_cuda("alp_match_fused", q, pt, v, part, out)
    kernels.launch("ptk_alp_match", q.data_ptr(), pt.data_ptr(),
                   v.data_ptr(), part.data_ptr(), out.data_ptr(), n, c,
                   h * w, splits * ALP_SPLIT, device=dev)
    alp_match_fused.launches += 1
    return out


alp_match_fused.launches = 0


def score_prototypes(qry_fts: torch.Tensor, protos: Prototypes,
                     use_fused: bool = False) -> torch.Tensor:
    """qry_fts (N, C, H, W) -> (N, 1, H, W): sum over valid prototypes of
    softmax(20·cos) · 20·cos (reference alpmodule.py:67-77); ``use_fused``
    takes kernel K5."""
    if use_fused:
        return alp_match_fused(qry_fts, protos.protos, protos.valid)
    return _match(safe_l2_normalize(qry_fts, dim=1),
                  safe_l2_normalize(protos.protos, dim=1), protos.valid)


def score_global(qry_fts: torch.Tensor,
                 glb_protos: torch.Tensor) -> torch.Tensor:
    """'mask' mode: cosine ×20 against each shot's global prototype, max
    over shots (reference alpmodule.py:58-65).  Returns (N, 1, H, W)."""
    dot = torch.einsum("nchw,sc->nshw", qry_fts, glb_protos)
    qn = clamped_norm(qry_fts, dim=1)
    pnorm = clamped_norm(glb_protos, dim=1)
    cos = dot / (qn[:, None] * pnorm[None, :, None, None])
    return SIM_SCALE * torch.amax(cos, dim=1, keepdim=True)


def alp_score(qry_fts: torch.Tensor, sup_fts: torch.Tensor,
              sup_mask: torch.Tensor, mode: str, window: int,
              thresh: float, use_fused: bool = False) -> torch.Tensor:
    """ALP forward for one (query, support set) pair; qry (N, C, H, W),
    sup_fts (S, C, H, W), sup_mask (S, 1, H, W) -> (N, 1, H, W)."""
    if mode == "mask":
        return score_global(qry_fts, global_prototypes(sup_fts, sup_mask))
    grid = grid_prototypes(sup_fts, sup_mask, window, thresh)
    if mode == "gridconv":
        return score_prototypes(qry_fts, grid, use_fused)
    if mode == "gridconv+":
        glb = global_prototypes(sup_fts, sup_mask)
        valid = torch.ones(glb.shape[0], dtype=torch.bool,
                           device=glb.device)
        return score_prototypes(qry_fts, Prototypes(
            torch.cat([grid.protos, glb]), torch.cat([grid.valid, valid])),
            use_fused)
    raise ValueError(f"unknown ALP mode: {mode}")


def fg_score_with_fallback(qry_fts: torch.Tensor, sup_fts: torch.Tensor,
                           sup_mask: torch.Tensor, *, window: int,
                           fallback_window: int, thresh: float,
                           use_fused: bool = False) -> torch.Tensor:
    """FG scoring with the reference's fallback from 'gridconv+' to 'mask'
    when no pooled cell of the training-time window clears the threshold
    (grid_proto_fewshot.py:254-256).  Both branches are computed and one is
    selected on the device, so the host never waits on the data."""
    use_grid = torch.amax(avg_pool2d(sup_mask, fallback_window)) >= thresh
    grid = alp_score(qry_fts, sup_fts, sup_mask, "gridconv+", window, thresh,
                     use_fused)
    glob = alp_score(qry_fts, sup_fts, sup_mask, "mask", window, thresh)
    return torch.where(use_grid, grid, glob)
