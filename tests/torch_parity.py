"""Shared helpers of the port's parity tests against the JAX package: the
seeded weights both sides load, their JAX param trees, and mask Dice."""

import numpy as np
import torch

from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    from protosam_tpu.utils.torch_convert import convert_dinov2, convert_sam
except ImportError:
    pass


def seeded_state_dict(module, seed):
    """The synthetic fill, LayerNorm2d weights near 1, plus N(0, 0.05²)
    on every entry, so biases are non-zero and attention is far from
    uniform."""
    rng = np.random.default_rng(seed + 100)
    return {k: v + torch.from_numpy(
                0.05 * rng.standard_normal(tuple(v.shape), dtype=np.float32))
            for k, v in synthetic_state_dict(module, seed,
                                             unit_norm2d=True).items()}


def jax_coarse_params(sd):
    """FewShotSeg state_dict (``encoder.``-prefixed DINOv2) -> JAX params."""
    return {"encoder": convert_dinov2(
        {k[len("encoder."):]: v.numpy() for k, v in sd.items()})}


def jax_sam_params(sd):
    return convert_sam({k: v.numpy() for k, v in sd.items()})


def dice(a, b):
    a, b = np.asarray(a) > 0.5, np.asarray(b) > 0.5
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * (a & b).sum() / den


def record_calls(obj, name, out):
    """Wrap ``obj.name`` so each call appends its first output, as numpy,
    to ``out``."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        first = res[0]
        out.append(first.detach().cpu().numpy() if hasattr(first, "detach")
                   else np.asarray(first))
        return res

    setattr(obj, name, wrapped)
