"""Dilated ResNet-101 (the DeepLabV3 backbone) with frozen BatchNorm, JAX
``models/backbones/resnet.py``; reference
models/backbone/torchvision_backbones.py:12-58.

torchvision's ``deeplabv3_resnet101`` trunk (ResNet-101 with
``replace_stride_with_dilation=[False, True, True]``, output stride 8),
ASPP dropped, then a bias-free 1×1 ``localconv`` to 256 channels.  The keys
are torchvision's under ``backbone.`` (``backbone.layer3.0.downsample.1``),
the reference wrapper's layout, which JAX ``convert_deeplab_resnet101``
reads.  BatchNorm is frozen: ``y = x·(w/√(var+eps)) + (b − mean·w/√(var+
eps))``.  As in JAX, its four vectors are parameters (flax params), so a
training step moves them; ``num_batches_tracked`` is not kept.  The
convolutions are cuDNN's on the card: JAX computes them outside any Pallas
kernel.

``widths`` and ``layers`` are the published (64, 128, 256, 512) and (3, 4,
23, 3) unless a test-size variant (``models/alpnet/fewshot.py``) asks for
others; the stem is ``widths[0]`` wide, as torchvision's 64.

Traced (``utils/profiling.py``): ``resnet.encode`` around a forward pass,
counting its ``images``, ``convs`` (the convolutions it launches, 105 at
the published depth) and ``feature_hw`` (the side of its output grid), and
``resnet.stage`` around the stem (through the max-pool), each of layer1-4
and the localconv, its ``stage`` named.  ``bn_folds`` on ``resnet.encode``
counts the BatchNorms the call folded into their convolutions (104 at the
published depth after a load, a cast or a step; 0 once warm).

Inference folds each BatchNorm into the convolution before it
(``FrozenBatchNorm.fold``): the weights scaled by ``w/√(var+eps)`` and the
shift as a bias, computed in float32 and rounded to the compute dtype once,
then kept until the weights change.  On the card cuDNN's fused entries add
the bias, the residual and the ReLU in the convolution's epilogue.  Where
autograd tracks a parameter of the pair (the master-weights training
build), the convolution and ``FrozenBatchNorm.forward`` run apart, so a
step moves the BatchNorm's vectors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from protosam_tpu_torch.models.master import Conv2d
from protosam_tpu_torch.utils import profiling

PUBLISHED_LAYERS = (3, 4, 23, 3)
PUBLISHED_WIDTHS = (64, 128, 256, 512)


class FrozenBatchNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.running_mean = nn.Parameter(torch.zeros(c))
        self.running_var = nn.Parameter(torch.ones(c))
        self._fold = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = torch.sqrt(self.running_var + self.eps)
        scale = (self.weight / std).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight / std).to(
            x.dtype)
        return x * scale[:, None, None] + shift[:, None, None]

    def fold(self, conv: Conv2d) -> tuple[torch.Tensor, torch.Tensor]:
        """``conv``'s weight scaled by this BatchNorm and its shift, the
        pair's weight and bias in ``conv``'s compute dtype.  Kept with the
        ids, pointers, ``_version``s, dtypes and shapes of the five tensors
        it was built from, and ``eps``, the dtype and the device: a load, a
        cast, a move or an in-place step builds it anew, and the sources'
        storage stays alive with it, so an address cannot come back as
        another weight's.  Each build counts ``bn_folds`` on the open
        spans.  Built on every call for inference tensors, whose in-place
        writes move no ``_version``."""
        dt = conv.compute_dtype or conv.weight.dtype
        srcs = (conv.weight, self.weight, self.bias, self.running_mean,
                self.running_var)
        if any(t.is_inference() for t in srcs):
            profiling.count("bn_folds", 1)
            return self._folded(conv.weight, dt)
        key = (self.eps, dt, conv.weight.device,
               *((id(t), t.data_ptr(), t._version, t.dtype, t.shape)
                 for t in srcs))
        hit = self._fold
        if hit is not None and hit[0] == key:
            return hit[2], hit[3]
        # plain tensors even when first built under inference_mode
        with torch.inference_mode(False), torch.no_grad():
            w, b = self._folded(conv.weight, dt)
        self._fold = (key, tuple(t.detach() for t in srcs), w, b)
        profiling.count("bn_folds", 1)
        return w, b

    def _folded(self, w: torch.Tensor,
                dt: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        scale = self.weight.float() / torch.sqrt(self.running_var.float()
                                                 + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return (w.float() * scale[:, None, None, None]).to(dt), shift.to(dt)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                  dilation=dilation, bias=False)


def _conv_bn(conv: Conv2d, bn: FrozenBatchNorm, x: torch.Tensor,
             residual: torch.Tensor | None = None,
             relu: bool = True) -> torch.Tensor:
    """``bn(conv(x))``, plus ``residual`` where given, then a ReLU where
    ``relu``.  Where autograd tracks none of the pair's parameters and
    inputs, one convolution with ``bn`` folded into it; on the card the
    bias, the residual and the ReLU in cuDNN's epilogue."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, residual, conv.weight, bn.weight, bn.bias,
                      bn.running_mean, bn.running_var)):
        y = bn(conv(x))
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y
    w, b = bn.fold(conv)
    geom = (conv.stride, conv.padding, conv.dilation, conv.groups)
    if x.is_cuda and relu:
        if residual is None:
            return torch.cudnn_convolution_relu(x, w, b, *geom)
        return torch.cudnn_convolution_add_relu(x, w, residual, 1.0, b,
                                                *geom)
    y = F.conv2d(x, w, b, *geom)
    if residual is not None:
        y += residual
    return F.relu_(y) if relu else y


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, dilation: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (nn.Sequential(_conv(cin, planes * 4, 1, stride),
                                         FrozenBatchNorm(planes * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _conv_bn(self.conv1, self.bn1, x)
        out = _conv_bn(self.conv2, self.bn2, out)
        identity = x if self.downsample is None else _conv_bn(
            *self.downsample, x, relu=False)
        return _conv_bn(self.conv3, self.bn3, out, residual=identity)


class ResNetTrunk(nn.Module):
    """torchvision ResNet's stem and layer1-4 (the keys of its
    IntermediateLayerGetter), dilated from layer3 on."""

    def __init__(self, layers: tuple = PUBLISHED_LAYERS,
                 widths: tuple = PUBLISHED_WIDTHS):
        super().__init__()
        cin = widths[0]
        self.conv1 = _conv(3, cin, 7, stride=2)
        self.bn1 = FrozenBatchNorm(cin)
        # (planes, blocks, stride, dilations): layer3/4 keep stride 1 and
        # dilate; each first block keeps the previous dilation
        specs = [(widths[0], layers[0], 1, [1] * layers[0]),
                 (widths[1], layers[1], 2, [1] * layers[1]),
                 (widths[2], layers[2], 1, [1] + [2] * (layers[2] - 1)),
                 (widths[3], layers[3], 1, [2] + [4] * (layers[3] - 1))]
        for li, (planes, blocks, stride, dils) in enumerate(specs, start=1):
            blks = []
            for bi in range(blocks):
                blks.append(Bottleneck(
                    cin, planes, stride if bi == 0 else 1, dils[bi],
                    bi == 0 and (stride != 1 or cin != planes * 4)))
                cin = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*blks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        with profiling.span("resnet.stage", device=dev, stage="stem"):
            x = _conv_bn(self.conv1, self.bn1, x)
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(1, 5):
            with profiling.span("resnet.stage", device=dev,
                                stage=f"layer{li}"):
                x = getattr(self, f"layer{li}")(x)
        return x


class DeeplabRes101Encoder(nn.Module):
    """(B, 3, H, W) -> (B, 256, ceil(H/8), ceil(W/8)) in the compute
    dtype."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, layers: tuple = PUBLISHED_LAYERS,
                 widths: tuple = PUBLISHED_WIDTHS):
        super().__init__()
        self.backbone = ResNetTrunk(layers, widths)
        self.localconv = _conv(widths[3] * 4, 256, 1)
        self.convs = sum(isinstance(m, nn.Conv2d) for m in self.modules())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        with profiling.span("resnet.encode", device=dev, images=x.shape[0],
                            convs=self.convs, bn_folds=0) as enc:
            dt = self.compute_dtype or self.localconv.weight.dtype
            y = self.backbone(x.to(dt))
            with profiling.span("resnet.stage", device=dev,
                                stage="localconv"):
                y = self.localconv(y)
            enc.attrs["feature_hw"] = y.shape[-1]
        return y
