"""Family ``deeplab_r101``: torchvision's ``deeplabv3_resnet101`` trunk as
ProtoSAM's coarse encoder (ProtoSAM, arXiv:2407.07042,
``models/backbone/torchvision_backbones.py``; ALPNet, arXiv:2007.09886;
torchvision ``models/resnet.py`` and ``models/segmentation/deeplabv3.py``),
at a configuration's ``coarse`` section (``layers``, ``widths``,
``dilations``, ``out_channels``, ``patch_size``, ``input_size``).

Bottlenecks (1×1, 3×3 carrying the stride and the dilation, 1×1 to four
times the width, each followed by BatchNorm; ReLU after the first two and
after the residual add; a strided 1×1 and a BatchNorm as the downsample of
a layer's first block), after a 7×7 stride-2 stem, BatchNorm, ReLU and a
3×3 stride-2 max-pool.  ``dilations`` gives each layer's (first block,
later blocks): by ``replace_stride_with_dilation``, a layer whose dilation
grows past the previous layer's replaced its stride of 2 by it, and its
first block keeps the previous dilation ([1, 1], [1, 1], [1, 2], [2, 4]:
output stride 8, the configuration's ``patch_size``).  BatchNorm in
inference mode, eps 1e-5.  Departures from torchvision: the ASPP head is
dropped and a bias-free 1×1 ``localconv`` to ``out_channels`` added, as
ProtoSAM's wrapper does; ``num_batches_tracked`` is not kept.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import models as M

EXPANSION = 4
EPS = 1e-5


def blocks(sec: dict) -> list:
    """``(prefix, cin, planes, stride, dilation, downsample)`` of every
    bottleneck in order (torchvision's ``_make_layer``)."""
    out, cin, prev = [], sec["widths"][0], 1
    for li, (n, planes, (first, rest)) in enumerate(
            zip(sec["layers"], sec["widths"], sec["dilations"]), start=1):
        if first != prev:
            raise ValueError(f"layer{li}'s first block must keep the "
                             f"previous dilation {prev}, not {first}")
        stride = 1 if li == 1 or rest > prev else 2
        for bi in range(n):
            out.append((f"layer{li}.{bi}.", cin, planes,
                        stride if bi == 0 else 1, first if bi == 0 else rest,
                        bi == 0 and (stride != 1
                                     or cin != planes * EXPANSION)))
            cin = planes * EXPANSION
        prev = rest
    return out


def _bn_keys(p: str, c: int) -> list:
    return [(p + ".weight", (c,), "norm"), (p + ".bias", (c,), "bias"),
            (p + ".running_mean", (c,), "bias"),
            (p + ".running_var", (c,), "norm")]


def keys(sec: dict, prefix: str) -> list:
    """torchvision's layout under ``<prefix>backbone.``, then
    ``<prefix>localconv.weight``."""
    p = prefix + "backbone."
    stem = sec["widths"][0]
    out = [(p + "conv1.weight", (stem, 3, 7, 7), "other"),
           *_bn_keys(p + "bn1", stem)]
    for b, cin, planes, _, _, down in blocks(sec):
        b = p + b
        wide = planes * EXPANSION
        out += [(b + "conv1.weight", (planes, cin, 1, 1), "other"),
                *_bn_keys(b + "bn1", planes),
                (b + "conv2.weight", (planes, planes, 3, 3), "other"),
                *_bn_keys(b + "bn2", planes),
                (b + "conv3.weight", (wide, planes, 1, 1), "other"),
                *_bn_keys(b + "bn3", wide)]
        if down:
            out += [(b + "downsample.0.weight", (wide, cin, 1, 1), "other"),
                    *_bn_keys(b + "downsample.1", wide)]
    last = sec["widths"][3] * EXPANSION
    return out + [(prefix + "localconv.weight",
                   (sec["out_channels"], last, 1, 1), "other")]


def _bn(x, w, p):
    shape = (1, -1, 1, 1)
    return ((x - w[p + ".running_mean"].reshape(shape))
            / torch.sqrt(w[p + ".running_var"].reshape(shape) + EPS)
            * w[p + ".weight"].reshape(shape) + w[p + ".bias"].reshape(shape))


def _block(x, w, p, stride, dilation, down):
    out = F.relu(_bn(F.conv2d(x, w[p + "conv1.weight"]), w, p + "bn1"))
    out = F.relu(_bn(F.conv2d(out, w[p + "conv2.weight"], stride=stride,
                              padding=dilation, dilation=dilation),
                     w, p + "bn2"))
    out = _bn(F.conv2d(out, w[p + "conv3.weight"]), w, p + "bn3")
    if down:
        x = _bn(F.conv2d(x, w[p + "downsample.0.weight"], stride=stride),
                w, p + "downsample.1")
    return F.relu(out + x)


def forward(w: dict, x: torch.Tensor, sec: dict) -> torch.Tensor:
    """x (B, 3, H, W) -> the localconv's map as tokens (B, g², C), g the
    side over the output stride; ``w`` holds the keys without the
    prefix."""
    bw = {k[len("backbone."):]: v for k, v in w.items()
          if k.startswith("backbone.")}
    with M.no_tf32():
        y = F.relu(_bn(F.conv2d(x, bw["conv1.weight"], stride=2, padding=3),
                       bw, "bn1"))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for p, _, _, stride, dilation, down in blocks(sec):
            y = _block(y, bw, p, stride, dilation, down)
        y = F.conv2d(y, w["localconv.weight"])
    return y.flatten(2).transpose(1, 2)


def tokens(sec: dict) -> int:
    """No attention, so no sequence."""
    return 0


def flops(sec: dict) -> dict[str, float]:
    """One image's convolutions at 2 FLOP a multiply-add, by stage (the
    BatchNorms, ReLUs, residual adds and the max-pool not counted)."""
    def conv(side, cin, cout, k):
        return 2.0 * side * side * cin * cout * k * k

    side = math.ceil(sec["input_size"] / 2)
    stem = sec["widths"][0]
    out = {"resnet stem": conv(side, 3, stem, 7)}
    side = math.ceil(side / 2)
    for p, cin, planes, stride, _, down in blocks(sec):
        key = "resnet " + p.split(".")[0]
        below = math.ceil(side / stride)
        wide = planes * EXPANSION
        f = (conv(side, cin, planes, 1) + conv(below, planes, planes, 3)
             + conv(below, planes, wide, 1))
        if down:
            f += conv(below, cin, wide, 1)
        out[key] = out.get(key, 0.0) + f
        side = below
    out["resnet localconv"] = conv(side, sec["widths"][3] * EXPANSION,
                                   sec["out_channels"], 1)
    return out
