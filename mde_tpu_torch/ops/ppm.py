"""Pyramid Pooling Module on NHWC tensors (``mde_tpu/ops/ppm.py:21-56``).

Parameter names follow the reference torch state dict
(``conv_reduce_layers.{i}.{0,1}`` and ``conv.{0,1}``), the names
``mde_tpu.core.family_converters._oda2_ppm`` converts from.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .conv import Conv1x1
from .pad import pad2d
from .resize import adaptive_avg_pool2d, resize_bilinear
from .tnn import BatchNorm, conv2d_nhwc, gelu


class EdgeConv3x3(nn.Conv2d):
    """Bias-free 3x3 conv after a one-pixel replicate pad, on NHWC input."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(pad2d(x, 1, 1, 1, 1, mode="edge"), self.weight)


class PyramidPoolingModule(nn.Module):
    """For each pooled size: adaptive average pool -> bias-free 1x1 conv to
    ``proj_ch`` -> BatchNorm -> GELU -> align-corners bilinear resize back;
    concatenated after the input -> replicate-pad 3x3 conv to ``out_ch`` ->
    BatchNorm -> GELU."""

    def __init__(self, in_ch: int, proj_ch: int, out_ch: int,
                 spatial_sizes: Sequence[int] = (1, 2, 3, 6), bn_eps: float = 1e-5):
        super().__init__()
        self.spatial_sizes = tuple(spatial_sizes)
        self.conv_reduce_layers = nn.ModuleList(
            nn.Sequential(Conv1x1(in_ch, proj_ch, bias=False), BatchNorm(proj_ch, eps=bn_eps))
            for _ in self.spatial_sizes)
        self.conv = nn.Sequential(EdgeConv3x3(in_ch + len(self.spatial_sizes) * proj_ch, out_ch),
                                  BatchNorm(out_ch, eps=bn_eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        spp = [x]
        for size, reduce in zip(self.spatial_sizes, self.conv_reduce_layers):
            red = gelu(reduce(adaptive_avg_pool2d(x, (size, size))))
            spp.append(resize_bilinear(red, (h, w), align_corners=True))
        return gelu(self.conv(torch.cat(spp, dim=-1)))
