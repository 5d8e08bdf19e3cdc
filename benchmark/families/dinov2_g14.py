"""Family ``dinov2_g14``: DINOv2 ViT-g/14 as the coarse encoder
(facebookresearch/dinov2 ``hubconf`` ``dinov2_vitg14``: ``vit_giant2``
with ``ffn_layer="swiglufused"``, ``dinov2/layers/swiglu_ffn.py``;
arXiv:2304.07193), at a configuration's ``coarse`` section (``dinov2.py``'s
keys, and ``ffn_hidden``).

Everything but the FFN is ``dinov2.py``'s.  The FFN is gated:
``w3(silu(x1) * x2)`` with ``x1, x2 = w12(x).chunk(2, -1)``, ``w12`` (2h, C)
and ``w3`` (C, h) with biases, h = (int(mlp_ratio·C·2/3) + 7) // 8 · 8
(4096 at C = 1536); three matrices, 3·h·C multiply-adds a token.
"""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.families import dinov2
from benchmark.reference import models as M


def hidden(sec: dict) -> int:
    """The hub's rule; the configuration states its result as
    ``ffn_hidden``, and the two must agree."""
    h = (int(int(sec["embed_dim"] * sec["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8
    if sec.get("ffn_hidden", h) != h:
        raise ValueError(f"ffn_hidden {sec['ffn_hidden']} is not the hub's "
                         f"{h}")
    return h


def mlp_keys(b: str, c: int, sec: dict) -> list:
    """w12 and w3 of block prefix ``b``."""
    h = hidden(sec)
    return [*M.linear_keys(b + "mlp.w12", 2 * h, c),
            *M.linear_keys(b + "mlp.w3", c, h)]


def mlp(w: dict, p: str, y):
    """w3(silu(x1) * x2) of block prefix ``p``."""
    x1, x2 = M.lin(y, w, p + "mlp.w12").chunk(2, dim=-1)
    return M.lin(F.silu(x1) * x2, w, p + "mlp.w3")


def keys(sec: dict, prefix: str) -> list:
    return dinov2.keys(sec, prefix, mlp_keys=mlp_keys)


def forward(w: dict, x, sec: dict):
    return dinov2.forward(w, x, sec, mlp=mlp)


def tokens(sec: dict) -> int:
    return dinov2.tokens(sec)


def flops(sec: dict) -> dict[str, float]:
    return dinov2.flops(sec, ffn_weights=3 * hidden(sec) * sec["embed_dim"])
