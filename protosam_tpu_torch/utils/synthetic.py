"""Role-aware synthetic weights from a numpy seed, and the synthetic
slices and support episode that the smoke run and the tools drive the
pipeline with.

Filling every tensor with N(0, 0.02²) would make normalisation scales ~0,
degenerate the activations and let the data-dependent stages (CCA, prompt
top-k, the empty-prediction fallback) take unrepresentatively cheap paths.
So tensors are filled by role, with the roles of the JAX package's
``utils/synthetic.synthetic_params`` (the ``bench.py`` recipe):

  * LayerNorm / LayerScale weights -> 1 + 0.02·N(0, 1)  (flax ``scale`` /
                                      ``gamma``)
  * biases                         -> 0
  * everything else                -> 0.02·N(0, 1)

LayerNorm2d's weight is "everything else" there: its flax leaf is named
``weight``, so SAM's neck, mask-downscaling and output-upscaling norms get
0.02·N(0, 1), as here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.layers import LayerNorm2d, TokenLayerNorm
from protosam_tpu_torch.ops.resize import resize_bilinear

_NORMS = (TokenLayerNorm, nn.LayerNorm)


def synthetic_state_dict(module: nn.Module, seed: int = 0,
                         unit_norm2d: bool = False) -> dict[str, torch.Tensor]:
    """f32 CPU tensors for every ``state_dict`` entry of ``module`` (which
    may live on the meta device), drawn in key order from one generator.
    ``unit_norm2d`` gives LayerNorm2d weights the norms' 1 + 0.02·N (the
    same draws plus 1): the tests' tiny SAM decodes all-foreground masks
    from JAX's 0.02·N."""
    rng = np.random.default_rng(seed)
    norms = _NORMS + ((LayerNorm2d,) if unit_norm2d else ())
    norm_weights = {f"{name}.weight" for name, m in module.named_modules()
                    if isinstance(m, norms)}
    out = {}
    for key, t in module.state_dict().items():
        noise = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        leaf = key.rsplit(".", 1)[-1]
        if key in norm_weights or leaf == "gamma":
            vals = 1.0 + 0.02 * noise
        elif leaf == "bias":
            vals = np.zeros_like(noise)
        else:
            vals = 0.02 * noise
        out[key] = torch.from_numpy(vals)
    return out


def materialize(module: nn.Module, device: torch.device | str,
                seed: int = 0) -> nn.Module:
    """Allocate ``module`` (built on the meta device or anywhere) on
    ``device`` and fill it with the synthetic weights of ``seed``."""
    sd = synthetic_state_dict(module, seed)
    module.to_empty(device=device)
    module.load_state_dict(sd)
    return module.eval()


def smooth_volume(n: int, size: int, seed: int) -> torch.Tensor:
    """n low-frequency slices (N, 3, size, size): random 21² fields
    upsampled, ×3 (the ``bench.py`` recipe), so the coarse mask has
    anatomy-like structure instead of white noise."""
    g = torch.Generator().manual_seed(seed)
    return resize_bilinear(torch.randn(n, 3, 21, 21, generator=g),
                           (size, size)) * 3.0


def synthetic_episode(size: int, device: torch.device | str,
                      seed: int) -> ALPNetInput:
    """One support slice with a centred square label (the middle third)."""
    g = torch.Generator().manual_seed(seed)
    supp = torch.randn(1, 3, size, size, generator=g)
    fg = torch.zeros(1, size, size)
    q = size // 3
    fg[:, q:2 * q, q:2 * q] = 1.0
    return ALPNetInput(supp, fg, supp).to(device)
