"""UPerHead, an FPN decode head (``mde_tpu/models/newcrfs/uper.py``).

The reference defines it beside the PSP head, and ``NewCRFDepth`` never
builds it: per-level lateral 1x1 convs, top-down align_corners=False
bilinear adds, one 3x3 smoothing conv on the finest map, which it returns.
mmcv's ConvModule at the reference's defaults is a biased conv and ReLU;
``use_norm`` adds a BatchNorm and drops the conv's bias (mmcv's rule).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.conv import ZeroPadConv
from ...ops.resize import resize_bilinear
from ...ops.tnn import BatchNorm


class UPerConv(nn.Module):
    """conv (zero padding) [-> BatchNorm] -> ReLU, named ``conv`` and ``bn``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, use_norm: bool,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.conv = ZeroPadConv(in_ch, out_ch, kernel_size, bias=not use_norm)
        self.bn = BatchNorm(out_ch, eps=bn_eps) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return torch.relu(y if self.bn is None else self.bn(y))


class UPerHead(nn.Module):
    """FPN top-down decode head over per-level NHWC features, finest first."""

    def __init__(self, in_channels: Sequence[int], channels: int = 512,
                 use_norm: bool = False, bn_eps: float = 1e-5):
        super().__init__()
        self.lateral_convs = nn.ModuleList(UPerConv(c, channels, 1, use_norm, bn_eps)
                                           for c in in_channels)
        # the reference's names; JAX builds the finest level's alone
        self.fpn_convs = nn.ModuleList([UPerConv(channels, channels, 3, use_norm, bn_eps)])

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[1:3], align_corners=False)
        return self.fpn_convs[0](laterals[0])
