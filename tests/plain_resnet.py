"""Plain float32 DeepLabV3 ResNet-101 trunk over a torchvision-layout state
dict, for the tests of the port's ``models/backbones/resnet.py``: plain
``torch`` operations only (nothing of either package, no JAX), TF32 off.

It follows torchvision: ``torchvision/models/resnet.py`` (``Bottleneck``:
1×1, 3×3 carrying the stride and the dilation, 1×1 to four times the
width, each followed by BatchNorm, ReLU after the first two and after the
residual add; the downsample a strided 1×1 and a BatchNorm; the stem a
7×7 stride-2 convolution, BatchNorm, ReLU and a 3×3 stride-2 max-pool;
``replace_stride_with_dilation``: a replaced stride of 2 becomes a
doubled dilation, the layer's first block keeping the previous one) and
``torchvision/models/segmentation/deeplabv3.py`` (``deeplabv3_resnet101``:
``[False, True, True]``, output stride 8), as ProtoSAM wraps it
(``models/backbone/torchvision_backbones.py``).  BatchNorm is in
inference mode: ``(x − running_mean) / √(running_var + eps) · weight +
bias``, eps 1e-5.  Departures:

* the ASPP head is dropped and a bias-free 1×1 ``localconv`` from the
  last layer's channels to 256 added, as ProtoSAM's wrapper does;
* ``num_batches_tracked`` is not kept (inference never reads it);
* ``layers`` and ``widths`` may name a test-size trunk (the published
  (3, 4, 23, 3) and (64, 128, 256, 512) by default; the stem is
  ``widths[0]`` wide).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LAYERS = (3, 4, 23, 3)
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
EPS = 1e-5
# replace_stride_with_dilation of deeplabv3_resnet101, for layer2-4
REPLACE = (False, True, True)


@contextlib.contextmanager
def no_tf32():
    """Full float32 matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def blocks(layers=LAYERS, widths=WIDTHS):
    """``(prefix, cin, planes, stride, dilation, downsample)`` of every
    bottleneck in order, by torchvision's ``_make_layer``."""
    out, cin, dilation = [], widths[0], 1
    for li, (n, planes) in enumerate(zip(layers, widths), start=1):
        stride, previous = (1 if li == 1 else 2), dilation
        if li > 1 and REPLACE[li - 2]:
            dilation *= stride
            stride = 1
        for bi in range(n):
            first = bi == 0
            out.append((f"backbone.layer{li}.{bi}.", cin, planes,
                        stride if first else 1,
                        previous if first else dilation,
                        first and (stride != 1 or cin != planes * EXPANSION)))
            cin = planes * EXPANSION
    return out


def layout(layers=LAYERS, widths=WIDTHS) -> dict[str, tuple]:
    """The port's ``state_dict`` keys and shapes (without
    ``num_batches_tracked``)."""
    def bn(p, c):
        return {f"{p}.{k}": (c,) for k in ("weight", "bias", "running_mean",
                                           "running_var")}

    out = {"backbone.conv1.weight": (widths[0], 3, 7, 7),
           **bn("backbone.bn1", widths[0])}
    for p, cin, planes, _, _, down in blocks(layers, widths):
        out[p + "conv1.weight"] = (planes, cin, 1, 1)
        out.update(bn(p + "bn1", planes))
        out[p + "conv2.weight"] = (planes, planes, 3, 3)
        out.update(bn(p + "bn2", planes))
        out[p + "conv3.weight"] = (planes * EXPANSION, planes, 1, 1)
        out.update(bn(p + "bn3", planes * EXPANSION))
        if down:
            out[p + "downsample.0.weight"] = (planes * EXPANSION, cin, 1, 1)
            out.update(bn(p + "downsample.1", planes * EXPANSION))
    out["localconv.weight"] = (256, widths[3] * EXPANSION, 1, 1)
    return out


def batch_norm(x, sd, p, eps=EPS):
    shape = (1, -1, 1, 1)
    return ((x - sd[p + ".running_mean"].reshape(shape))
            / torch.sqrt(sd[p + ".running_var"].reshape(shape) + eps)
            * sd[p + ".weight"].reshape(shape) + sd[p + ".bias"].reshape(shape))


def bottleneck(x, sd, p, stride, dilation, down, eps=EPS):
    out = F.relu(batch_norm(F.conv2d(x, sd[p + "conv1.weight"]), sd,
                            p + "bn1", eps))
    out = F.relu(batch_norm(F.conv2d(out, sd[p + "conv2.weight"],
                                     stride=stride, padding=dilation,
                                     dilation=dilation), sd, p + "bn2", eps))
    out = batch_norm(F.conv2d(out, sd[p + "conv3.weight"]), sd, p + "bn3",
                     eps)
    identity = x
    if down:
        identity = batch_norm(F.conv2d(x, sd[p + "downsample.0.weight"],
                                       stride=stride), sd,
                              p + "downsample.1", eps)
    return F.relu(out + identity)


def forward(sd: dict, x: torch.Tensor, layers=LAYERS, widths=WIDTHS,
            stages: bool = False, eps: float = EPS):
    """x (B, 3, H, W) -> the localconv's (B, 256, ceil(H/8), ceil(W/8)) in
    float32; with ``stages`` a dict of every stage's output (``stem``
    after the max-pool, ``layer1``-``layer4``, ``localconv``)."""
    sd = {k: v.float() for k, v in sd.items()}
    out = {}
    with no_tf32():
        y = F.conv2d(x.float(), sd["backbone.conv1.weight"], stride=2,
                     padding=3)
        y = F.relu(batch_norm(y, sd, "backbone.bn1", eps))
        out["stem"] = y = F.max_pool2d(y, 3, stride=2, padding=1)
        for p, _, _, stride, dilation, down in blocks(layers, widths):
            y = bottleneck(y, sd, p, stride, dilation, down, eps)
            out[p.split(".")[1]] = y
        out["localconv"] = y = F.conv2d(y, sd["localconv.weight"])
    return out if stages else y
