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
0.02·N(0, 1), as here.  The ResNet's frozen BatchNorm, which no JAX tool
fills, takes the norms' roles for its weight and bias, 0.02·N for its
running mean and 1 + 0.02·N for its running variance, which must stay
positive.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from protosam_tpu_torch.models.backbones.resnet import FrozenBatchNorm
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.layers import LayerNorm2d, TokenLayerNorm
from protosam_tpu_torch.ops.resize import resize_bilinear

_NORMS = (TokenLayerNorm, nn.LayerNorm, FrozenBatchNorm)


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
        if key in norm_weights or leaf in ("gamma", "running_var"):
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


# ----------------------------------------------------------------------
# The tiny SAM of the recorded reference masks (tests/goldens/ref_masks)
# and its deterministic inputs.  The masks were recorded from the PyTorch
# reference's ProtoSAM.forward (models/ProtoSAM.py:536-678) on a tiny SAM
# whose weights the reference drew as ``randn(shape) * 0.05`` per
# state_dict key, in key order, from one generator seeded 42, with ``* 3.2``
# on the hypernetworks' last layer (so that mask logits have a real
# dynamic range).  The port's vit_t ``Sam`` at 256 px has the same keys,
# shapes and order, so the same draws land on the same parameters.
# ----------------------------------------------------------------------

TINY_SAM_KW = dict(embed_dim=160, depth=2, num_heads=4,
                   global_attn_indexes=(1,), image_size=256)


def _linear(prefix: str) -> list[str]:
    return [f"{prefix}.weight", f"{prefix}.bias"]


def reference_key_order(depth: int, n_decoder_layers: int = 2,
                        n_mask_tokens: int = 4) -> list[str]:
    """The reference tiny SAM's state_dict keys in order, written down from
    its module definitions (the vendored segment_anything): a module's own
    parameters and buffers first, then its children in the order its
    ``__init__`` assigns them."""
    keys = ["image_encoder.pos_embed",
            *_linear("image_encoder.patch_embed.proj")]
    for i in range(depth):
        b = f"image_encoder.blocks.{i}"
        keys += [*_linear(f"{b}.norm1"), f"{b}.attn.rel_pos_h",
                 f"{b}.attn.rel_pos_w", *_linear(f"{b}.attn.qkv"),
                 *_linear(f"{b}.attn.proj"), *_linear(f"{b}.norm2"),
                 *_linear(f"{b}.mlp.lin1"), *_linear(f"{b}.mlp.lin2")]
    keys += ["image_encoder.neck.0.weight", *_linear("image_encoder.neck.1"),
             "image_encoder.neck.2.weight", *_linear("image_encoder.neck.3")]
    pe = "prompt_encoder"
    keys += [f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
             *[f"{pe}.point_embeddings.{i}.weight" for i in range(4)],
             f"{pe}.not_a_point_embed.weight",
             *[k for i in (0, 1, 3, 4, 6)
               for k in _linear(f"{pe}.mask_downscaling.{i}")],
             f"{pe}.no_mask_embed.weight"]

    def attention(p):
        return [k for proj in ("q_proj", "k_proj", "v_proj", "out_proj")
                for k in _linear(f"{p}.{proj}")]

    t = "mask_decoder.transformer"
    for i in range(n_decoder_layers):
        lay = f"{t}.layers.{i}"
        keys += [*attention(f"{lay}.self_attn"), *_linear(f"{lay}.norm1"),
                 *attention(f"{lay}.cross_attn_token_to_image"),
                 *_linear(f"{lay}.norm2"), *_linear(f"{lay}.mlp.lin1"),
                 *_linear(f"{lay}.mlp.lin2"), *_linear(f"{lay}.norm3"),
                 *_linear(f"{lay}.norm4"),
                 *attention(f"{lay}.cross_attn_image_to_token")]
    keys += [*attention(f"{t}.final_attn_token_to_image"),
             *_linear(f"{t}.norm_final_attn")]
    d = "mask_decoder"
    keys += [f"{d}.iou_token.weight", f"{d}.mask_tokens.weight",
             *_linear(f"{d}.output_upscaling.0"),
             *_linear(f"{d}.output_upscaling.1"),
             *_linear(f"{d}.output_upscaling.3")]
    for i in range(n_mask_tokens):
        keys += [k for j in range(3)
                 for k in _linear(f"{d}.output_hypernetworks_mlps.{i}"
                                  f".layers.{j}")]
    keys += [k for j in range(3)
             for k in _linear(f"{d}.iou_prediction_head.layers.{j}")]
    return keys


def tiny_sam() -> nn.Module:
    """The port's vit_t ``Sam`` at 256 px (``TINY_SAM_KW``), unfilled."""
    from protosam_tpu_torch.models.sam.sam import Sam

    kw = TINY_SAM_KW
    return Sam(encoder_embed_dim=kw["embed_dim"],
               encoder_depth=kw["depth"], encoder_num_heads=kw["num_heads"],
               encoder_global_attn_indexes=kw["global_attn_indexes"],
               image_size=kw["image_size"]).eval()


def reference_draws(sam: nn.Module) -> dict[str, torch.Tensor]:
    """The reference tiny SAM's weights drawn over ``sam``'s state_dict,
    which must be in the reference's key order."""
    g = torch.Generator().manual_seed(42)
    sd = {}
    for k, v in sam.state_dict().items():
        scale = 3.2 if ("output_hypernetworks_mlps" in k
                        and ".layers.2." in k) else 0.05
        sd[k] = torch.randn(v.shape, generator=g) * scale
    return sd


def seeded_tiny_sam(device: torch.device | str = "cpu") -> nn.Module:
    """``tiny_sam()`` with ``reference_draws`` on ``device``, f32."""
    sam = tiny_sam()
    sam.load_state_dict(reference_draws(sam))
    return sam.to(device)


def _det_noise(h: int, w: int, salt: int) -> np.ndarray:
    """Deterministic hash noise in [-0.5, 0.5): analytic (sin / frac), so
    the cases reproduce bit for bit on any numpy."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    v = np.sin(xx * 12.9898 + yy * 78.233 + salt * 37.719) * 43758.5453
    return (v - np.floor(v) - 0.5).astype(np.float32)


# per-slice blob lists (cy, cx, r, gain) of the recorded volume: an organ
# that appears, drifts and grows, splits into components, shrinks and
# vanishes (single-component, multi-component and empty predictions)
AGREEMENT_BLOBS = [
    [(90, 90, 27, 5.0)],
    [(100, 104, 30, 5.5), (185, 70, 14, 4.0)],
    [(112, 120, 26, 5.0), (180, 178, 18, 4.5), (70, 190, 13, 4.0)],
    [(126, 134, 22, 4.8), (172, 186, 15, 4.2)],
    [(138, 146, 15, 4.2)],
    [],
]


def synthetic_agreement_case(i: int, hw: int = 256
                             ) -> tuple[np.ndarray, np.ndarray]:
    """The (query (1, 3, hw, hw), coarse logits (1, 2, hw, hw)) pair of
    recorded slice ``i``, in the SAM frame so that no input resize runs."""
    blobs = AGREEMENT_BLOBS[i % len(AGREEMENT_BLOBS)]
    yy, xx = np.mgrid[0:hw, 0:hw]
    fg = np.full((hw, hw), -2.0, np.float32)
    base = np.zeros((hw, hw), np.float32)
    for (cy, cx, r, gain) in blobs:
        bump = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                        / (2.0 * r * r))).astype(np.float32)
        fg += gain * bump
        base += 0.6 * bump
    fg += 0.15 * _det_noise(hw, hw, salt=3 * i + 1)
    logits = np.stack([-fg, fg])[None].astype(np.float32)
    qry = np.stack([
        base + 0.3 * _det_noise(hw, hw, salt=3 * i + 2),
        0.8 * base + 0.3 * _det_noise(hw, hw, salt=3 * i + 3),
        0.6 * base + 0.3 * _det_noise(hw, hw, salt=3 * i + 4),
    ])[None].astype(np.float32)
    return qry, logits


def structured_sam_state_dict(sam: nn.Module, seed: int = 1
                              ) -> dict[str, torch.Tensor]:
    """Weights for ``sam`` (any ``build_sam`` type, on any device) under
    which point-prompted masks vary in area and stability, for the
    automatic mask generator: the synthetic fill with LayerNorm2d weights
    near 1, plus N(0, 0.05²) on every entry, and the hypernetworks' last
    layer ×10 (the recorded recipe's draws, and JAX's synthetic recipe,
    give masks that are empty or full under one grid point, stability 0).
    f32 CPU tensors."""
    rng = np.random.default_rng(seed + 100)
    sd = {}
    for k, v in synthetic_state_dict(sam, seed, unit_norm2d=True).items():
        v = v + torch.from_numpy(0.05 * rng.standard_normal(
            tuple(v.shape), dtype=np.float32))
        if "output_hypernetworks_mlps" in k and ".layers.2." in k:
            v = v * 10.0
        sd[k] = v
    return sd


def structured_tiny_sam(device: torch.device | str = "cpu",
                        seed: int = 1) -> nn.Module:
    """A vit_t ``Sam`` at 256 px with ``structured_sam_state_dict``
    weights, f32 on ``device``."""
    from protosam_tpu_torch.models.sam.registry import build_sam

    sam = build_sam("vit_t", image_size=256).eval()
    sam.load_state_dict(structured_sam_state_dict(sam, seed))
    return sam.to(device)
