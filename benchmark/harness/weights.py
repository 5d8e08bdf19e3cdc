"""Synthetic weights from the seed, made on the card: a frozen copy of the
role recipe the program's own tools use (LayerNorm weights and LayerScale
gammas 1 + 0.02·N, biases 0, everything else 0.02·N; a plain N(0, 0.02²)
fill would shrink every normalisation to about 0 and degenerate the
masks).  One ``torch.randn`` call per model on a ``torch.Generator`` of the
card fills a flat float32 buffer; each tensor of the published layout
(``reference/layout.py``) is a view of it.  The same dicts go to the
program's builder and to the reference."""

from __future__ import annotations

import math

import torch

from benchmark.reference import layout


def _draw(keys: list, seed: int, device) -> dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in keys)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32).mul_(0.02)
    out, at = {}, 0
    for key, shape, role in keys:
        n = math.prod(shape)
        view = flat[at:at + n].view(shape)
        if role == "norm":
            view.add_(1.0)
        elif role == "bias":
            view.zero_()
        out[key] = view
        at += n
    return out


def coarse_keys(cfg: dict) -> list:
    c = cfg["coarse"]
    return layout.dinov2("encoder.", c["embed_dim"], c["depth"],
                         c["pos_grid"], c["patch_size"], c["mlp_ratio"])


def sam_keys(cfg: dict) -> list:
    s = cfg["sam"]
    return layout.sam(s["embed_dim"], s["depth"], s["num_heads"],
                      set(s["global_attn_indexes"]), s["image_size"],
                      s["patch_size"], s["window_size"],
                      s["prompt_embed_dim"])


def state_dicts(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(coarse model state dict, SAM state dict) of ``seed``, float32 on
    ``device``; the two draws come from two generators so that neither
    model's weights depend on the other's size."""
    return (_draw(coarse_keys(cfg), 2 * seed, device),
            _draw(sam_keys(cfg), 2 * seed + 1, device))


def strip(sd: dict, prefix: str) -> dict:
    """The entries of ``sd`` under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
