"""Conv + BN + GELU block on NHWC (``mde_tpu/ops/conv.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .pad import pad2d
from .tnn import BatchNorm, conv2d_nhwc, gelu


class ConvBN(nn.Module):
    """Replicate pad -> bias-free k x k conv -> BatchNorm (batch statistics
    in training, running ones in eval) -> GELU. Names match the reference's
    ``{conv, bn}``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bn_eps: float = 1e-5):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("ConvBN takes odd kernels only")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, bias=False)
        self.bn = BatchNorm(out_ch, eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.conv.kernel_size[0] // 2
        x = conv2d_nhwc(pad2d(x, p, p, p, p, mode="edge"), self.conv.weight)
        return gelu(self.bn(x))


class Conv1x1(nn.Conv2d):
    """1x1 conv on NHWC input, in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool):
        super().__init__(in_ch, out_ch, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias)
