"""Layers that keep f32 master weights under a lower compute dtype.

flax's ``Dense(dtype=bf16)`` / ``Conv(dtype=bf16)`` over f32 params cast the
input and the params to bf16 at every use, so an optimizer steps the f32
params (JAX's trainer builds ``FewShotSeg(dtype=bf16)`` so,
``train/trainer.py:80-83``).  ``Linear`` and ``Conv2d`` do the same once
``compute_dtype`` is set (``models/layers.cast_compute(...,
master_weights=True)``); unset, they are ``nn.Linear`` / ``nn.Conv2d``, and
the inference builds, which round their params to the compute dtype once,
keep their bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: torch.Tensor | None, dt: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dt)


class Linear(nn.Linear):
    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))
