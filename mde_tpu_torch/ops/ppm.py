"""Pyramid Pooling Modules on NHWC tensors (``mde_tpu/ops/ppm.py``): the
ODA2 module (``:21-56``), the ODA gen-1 one (``PyramidPoolingModuleV1``,
``:59-98``) and the ODA Lion and Jeju decoders' ``PyramidPoolingModuleV2``
(JAX's ``PPMv2``, ``mde_tpu/models/oda/lion.py:201-228``).

Parameter names follow the reference torch state dicts
(``conv_reduce_layers.{i}.{0,1}`` and ``conv.{0,1}``; gen-1
``conv_reduce_layers.{i}``, ``conv`` and ``bn``; V2 the same three), the
names ``mde_tpu.core.family_converters._oda2_ppm``, ``_ppm_v1`` and
``_ppm_v2`` convert from.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .conv import Conv1x1, EdgeConv
from .resize import adaptive_avg_pool2d, resize_bilinear
from .tnn import BatchNorm, gelu


class EdgeConv3x3(EdgeConv):
    """3x3 conv (bias-free unless ``bias``) after a one-pixel replicate pad,
    on NHWC input."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = False):
        super().__init__(in_ch, out_ch, 3, bias=bias)


class PyramidPoolingModule(nn.Module):
    """For each pooled size: adaptive average pool -> bias-free 1x1 conv to
    ``proj_ch`` -> BatchNorm -> GELU -> align-corners bilinear resize back;
    concatenated after the input -> replicate-pad 3x3 conv to ``out_ch`` ->
    BatchNorm -> GELU."""

    def __init__(self, in_ch: int, proj_ch: int, out_ch: int,
                 spatial_sizes: Sequence[int] = (1, 2, 3, 6), bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__()
        self.spatial_sizes = tuple(spatial_sizes)
        bn = dict(eps=bn_eps, momentum=bn_momentum)
        self.conv_reduce_layers = nn.ModuleList(
            nn.Sequential(Conv1x1(in_ch, proj_ch, bias=False), BatchNorm(proj_ch, **bn))
            for _ in self.spatial_sizes)
        self.conv = nn.Sequential(EdgeConv3x3(in_ch + len(self.spatial_sizes) * proj_ch, out_ch),
                                  BatchNorm(out_ch, **bn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        spp = [x]
        for size, reduce in zip(self.spatial_sizes, self.conv_reduce_layers):
            red = gelu(reduce(adaptive_avg_pool2d(x, (size, size))))
            spp.append(resize_bilinear(red, (h, w), align_corners=True))
        return gelu(self.conv(torch.cat(spp, dim=-1)))


class PyramidPoolingModuleV1(nn.Module):
    """The ODA gen-1 PPM: for each pooled size, adaptive average pool ->
    biased 1x1 conv to in_ch / len(sizes) (no norm, no activation) ->
    align-corners bilinear resize back; concatenated after the input ->
    bias-free 1x1 conv to ``out_ch`` -> BatchNorm (no activation)."""

    def __init__(self, in_ch: int, out_ch: int, spatial_sizes: Sequence[int] = (1, 2, 3, 6),
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1):
        super().__init__()
        self.spatial_sizes = tuple(spatial_sizes)
        n = len(self.spatial_sizes)
        if in_ch % n:
            raise ValueError(f"{in_ch} channels do not split over {n} pooled sizes")
        self.conv_reduce_layers = nn.ModuleList(Conv1x1(in_ch, in_ch // n, bias=True)
                                                for _ in self.spatial_sizes)
        self.conv = Conv1x1(2 * in_ch, out_ch, bias=False)
        self.bn = BatchNorm(out_ch, eps=bn_eps, momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        spp = [x] + [resize_bilinear(reduce(adaptive_avg_pool2d(x, (size, size))), (h, w),
                                     align_corners=True)
                     for size, reduce in zip(self.spatial_sizes, self.conv_reduce_layers)]
        return self.bn(self.conv(torch.cat(spp, dim=-1)))


class PyramidPoolingModuleV2(nn.Module):
    """The ODA Lion and Jeju PPM: for each pooled size, adaptive average
    pool -> bias-free 1x1 conv to ``proj_ch`` (no norm, no activation) ->
    align-corners bilinear resize back; concatenated after the input ->
    BatchNorm -> GELU -> replicate-pad 3x3 conv with bias to ``out_ch``."""

    def __init__(self, in_ch: int, proj_ch: int, out_ch: int,
                 spatial_sizes: Sequence[int] = (1, 2, 3, 6), bn_momentum: float = 0.1):
        super().__init__()
        self.spatial_sizes = tuple(spatial_sizes)
        self.conv_reduce_layers = nn.ModuleList(Conv1x1(in_ch, proj_ch, bias=False)
                                                for _ in self.spatial_sizes)
        self.bn = BatchNorm(in_ch + len(self.spatial_sizes) * proj_ch, momentum=bn_momentum)
        self.conv = EdgeConv3x3(self.bn.num_features, out_ch, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        spp = [x] + [resize_bilinear(reduce(adaptive_avg_pool2d(x, (size, size))), (h, w),
                                     align_corners=True)
                     for size, reduce in zip(self.spatial_sizes, self.conv_reduce_layers)]
        return self.conv(gelu(self.bn(torch.cat(spp, dim=-1))))
