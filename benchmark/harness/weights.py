"""Synthetic weights from the seed, made on the card: a frozen copy of the
role recipe the program's own tools use (LayerNorm weights and LayerScale
gammas 1 + 0.02·N, biases 0, everything else 0.02·N; a plain N(0, 0.02²)
fill would shrink every normalisation to about 0 and degenerate the
masks).  One ``torch.randn`` call per model on a ``torch.Generator`` of the
card fills a flat float32 buffer; each tensor of the published layout (the
encoder family's ``keys``, ``harness/family.py``) is a view of it.  The
same dicts go to ``build_models`` and to the reference."""

from __future__ import annotations

import math

import torch

from benchmark.harness import family


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


def coarse_keys(cfg: dict, root=family.ROOT) -> list:
    """The coarse model's layout: ALPNet holds its encoder as
    ``encoder.``."""
    c = cfg["coarse"]
    return family.load(c, root).keys(c, "encoder.")


def sam_keys(cfg: dict, root=family.ROOT) -> list:
    s = cfg["sam"]
    return family.load(s, root).keys(s, "")


def state_dicts(cfg: dict, seed: int, device,
                root=family.ROOT) -> tuple[dict, dict]:
    """(coarse model state dict, SAM state dict) of ``seed``, float32 on
    ``device``; the two draws come from two generators so that neither
    model's weights depend on the other's size."""
    return (_draw(coarse_keys(cfg, root), 2 * seed, device),
            _draw(sam_keys(cfg, root), 2 * seed + 1, device))


def strip(sd: dict, prefix: str) -> dict:
    """The entries of ``sd`` under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
