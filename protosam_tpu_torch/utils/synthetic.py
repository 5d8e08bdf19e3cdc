"""Role-aware synthetic weights from a numpy seed.

Filling every tensor with N(0, 0.02²) would make normalisation scales ~0,
degenerate the activations and let the data-dependent stages (CCA, prompt
top-k, the empty-prediction fallback) take unrepresentatively cheap paths.
So tensors are filled by role, as a real checkpoint would have them:

  * LayerNorm / LayerScale weights -> 1 + 0.02·N(0, 1)
  * biases                         -> 0
  * everything else                -> 0.02·N(0, 1)
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from protosam_tpu_torch.models.layers import LayerNorm2d, TokenLayerNorm

_NORMS = (TokenLayerNorm, LayerNorm2d, nn.LayerNorm)


def synthetic_state_dict(module: nn.Module,
                         seed: int = 0) -> dict[str, torch.Tensor]:
    """f32 CPU tensors for every ``state_dict`` entry of ``module`` (which
    may live on the meta device), drawn in key order from one generator."""
    rng = np.random.default_rng(seed)
    norm_weights = {f"{name}.weight" for name, m in module.named_modules()
                    if isinstance(m, _NORMS)}
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
