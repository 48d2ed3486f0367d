"""EfficientNet encoder (``tf_efficientnet_b5_ap``) of AdaBins and
Depthformer (``mde_tpu/models/efficientnet.py``).

``EfficientNetFeatures`` returns the reference's full list of intermediate
maps, which the models index at fixed positions:

    [0] input                       [7]  blocks3  (1/16, 128)
    [1] conv_stem (1/2, 48)         [8]  blocks4  (1/16, 176)
    [2] bn1                         [9]  blocks5  (1/32, 304)
    [3] act1                        [10] blocks6  (1/32, 512)
    [4] blocks0  (1/2, 24)          [11] conv_head (1/32, 2048)
    [5] blocks1  (1/4, 40)          [12] act2
    [6] blocks2  (1/8, 64)

(channels at B5's width 1.6 and depth 2.2; without the head the list ends
at [10]). The "tf_" variant pads as TensorFlow's SAME does, the extra pixel
right and bottom, and its BatchNorms take eps 1e-3. The strided depthwise
convs are ``F.conv2d(..., groups=C)`` after that pad: cuDNN's grouped conv
on the card, as XLA's grouped conv on the TPU.

Parameter names follow the gen-efficientnet-pytorch state dict, the names
``mde_tpu.core.checkpoint.convert_efficientnet_b5`` (``:325-370``) converts
from: ``conv_stem``, ``bn1``, ``blocks.{stage}.{block}.{conv_pw, bn1,
conv_dw, bn2, se.conv_reduce, se.conv_expand, conv_pwl, bn3}`` (the first
stage's blocks ``conv_dw, bn1, se, conv_pw, bn2``), ``conv_head``; the
models hold it as ``encoder.original_model``.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv1x1
from ..ops.pad import pad2d
from ..ops.tnn import BatchNorm, conv2d_nhwc

# B0 stage template: (kernel, stride, expand, channels, repeats)
_B0_STAGES = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)
_BN_EPS = 1e-3  # the tf_ variants


def round_channels(c: float, multiplier: float, divisor: int = 8) -> int:
    """timm's channel rounding (to the nearest multiple, at least 90%)."""
    c *= multiplier
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, multiplier: float) -> int:
    return int(math.ceil(multiplier * r))


def tf_same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """TensorFlow's SAME zero padding of NHWC ``x`` for a ``kernel`` x
    ``kernel`` conv at ``stride``: the output has ceil(size / stride) rows
    and columns, and the odd pixel of padding goes right and bottom."""
    def amounts(size: int):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        return total // 2, total - total // 2

    (pt, pb), (pl, pr) = amounts(x.shape[1]), amounts(x.shape[2])
    return pad2d(x, pt, pb, pl, pr, mode="zeros")


class SameConv(nn.Conv2d):
    """k x k conv at ``stride`` after TF-SAME padding, on NHWC input, in the
    input's dtype; depthwise (``groups`` = channels) for ``conv_dw``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        return conv2d_nhwc(tf_same_pad(x, k, s), self.weight, self.bias, stride=s,
                           groups=self.groups)


class DepthwiseSameConv(SameConv):
    """Bias-free depthwise ``conv_dw``, drawn as the JAX block draws it:
    N(0, 2 / fan_out), flax's fan_out of a (k, k, C) kernel being k * C."""

    def __init__(self, channels: int, kernel: int, stride: int):
        super().__init__(channels, channels, kernel, stride=stride, groups=channels, bias=False)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        fan_out = self.kernel_size[0] * self.out_channels
        self.weight.data.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class SqueezeExcite(nn.Module):
    """x times the sigmoid of 1x1 convs (``conv_reduce``, SiLU,
    ``conv_expand``) of x's spatial mean, taken in f32 and cast back."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv1x1(channels, reduced, bias=True)
        self.conv_expand = Conv1x1(reduced, channels, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        return x * torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(s))))


class DepthwiseSeparable(nn.Module):
    """The first stage's block: ``conv_dw``, ``bn1``, SiLU, ``se``, the 1x1
    ``conv_pw``, ``bn2``; the input added where the shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 se_ratio: float = 0.25):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_dw = DepthwiseSameConv(in_ch, kernel, stride)
        self.bn1 = BatchNorm(in_ch, eps=_BN_EPS)
        self.se = SqueezeExcite(in_ch, max(1, int(in_ch * se_ratio)))
        self.conv_pw = Conv1x1(in_ch, out_ch, bias=False)
        self.bn2 = BatchNorm(out_ch, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv_pw(self.se(F.silu(self.bn1(self.conv_dw(x))))))
        return y + x if self.residual else y


class InvertedResidual(nn.Module):
    """MBConv: the 1x1 expansion ``conv_pw``, ``bn1``, SiLU, ``conv_dw``,
    ``bn2``, SiLU, ``se`` (its width from the block's input channels, as
    timm's), the 1x1 projection ``conv_pwl``, ``bn3``; the input added where
    the shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int,
                 se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_pw = Conv1x1(in_ch, mid, bias=False)
        self.bn1 = BatchNorm(mid, eps=_BN_EPS)
        self.conv_dw = DepthwiseSameConv(mid, kernel, stride)
        self.bn2 = BatchNorm(mid, eps=_BN_EPS)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.conv_pwl = Conv1x1(mid, out_ch, bias=False)
        self.bn3 = BatchNorm(out_ch, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = self.se(F.silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EfficientNetFeatures(nn.Module):
    """The B0 template scaled by ``width`` and ``depth`` (B5: 1.6 and 2.2),
    with the 1x1 ``conv_head`` unless ``with_head`` is off. ``forward``
    takes (B, H, W, 3) images and returns the features list of the module
    docstring, each map in the input's dtype; ``channels`` gives each
    entry's channel count."""

    def __init__(self, width: float = 1.6, depth: float = 2.2, stem_ch: int = 32,
                 head_ch: int = 1280, with_head: bool = True):
        super().__init__()
        stem = round_channels(stem_ch, width)
        self.conv_stem = SameConv(3, stem, 3, stride=2, bias=False)
        self.bn1 = BatchNorm(stem, eps=_BN_EPS)
        self.channels = [3, stem, stem, stem]
        stages = []
        in_ch = stem
        for k, s, e, c, r in _B0_STAGES:
            out_ch = round_channels(c, width)
            blocks = []
            for bi in range(round_repeats(r, depth)):
                stride = s if bi == 0 else 1
                blocks.append(DepthwiseSeparable(in_ch, out_ch, k, stride) if e == 1
                              else InvertedResidual(in_ch, out_ch, k, stride, e))
                in_ch = out_ch
            stages.append(nn.Sequential(*blocks))
            self.channels.append(out_ch)
        self.blocks = nn.ModuleList(stages)
        self.conv_head = None
        if with_head:
            head = round_channels(head_ch, width)
            self.conv_head = Conv1x1(in_ch, head, bias=False)
            self.channels += [head, head]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        y = self.conv_stem(x)
        feats.append(y)
        y = self.bn1(y)
        feats.append(y)
        y = F.silu(y)
        feats.append(y)
        for stage in self.blocks:
            y = stage(y)
            feats.append(y)  # one entry a stage, as the reference iterates them
        if self.conv_head is not None:
            y = self.conv_head(y)
            feats.append(y)
            feats.append(F.silu(y))
        return feats


class EfficientNetEncoder(nn.Module):
    """B5 (``width`` 1.6, ``depth`` 2.2 unless ``kwargs`` say otherwise)
    under the reference encoder's ``original_model``."""

    def __init__(self, **kwargs):
        super().__init__()
        kwargs.setdefault("width", 1.6)
        kwargs.setdefault("depth", 2.2)
        self.original_model = EfficientNetFeatures(**kwargs)

    @property
    def channels(self) -> List[int]:
        return self.original_model.channels

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.original_model(x)
