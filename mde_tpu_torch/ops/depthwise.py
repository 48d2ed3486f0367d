"""Depthwise conv module (``mde_tpu/ops/depthwise.py``), through kernel K3."""

from __future__ import annotations

import torch
from torch import nn

from .init import conv_kernel_normal_
from .kernels.depthwise import depthwise_conv2d


class DepthwiseConv2d(nn.Module):
    """Bias-free depthwise k x k conv with replicate padding on NHWC input.
    The weight keeps torch's (C, 1, k, k) layout; the kernel takes it as
    (k, k, C) in the input's dtype."""

    def __init__(self, channels: int, kernel_size: int = 5):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size, kernel_size))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        conv_kernel_normal_(self.weight.data, self.kernel_size, self.kernel_size, generator)

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight as the kernels take it: (k, k, C) in ``dtype``."""
        return self.weight[:, 0].permute(1, 2, 0).to(dtype).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv2d(x, self.kernel(x.dtype))
