"""Conv + BN + GELU block on NHWC (``mde_tpu/ops/conv.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .pad import pad2d
from .tnn import BatchNorm, GroupNorm, conv2d_nhwc, gelu


class ConvBN(nn.Module):
    """Replicate pad -> bias-free k x k conv -> BatchNorm (batch statistics
    in training, running ones in eval), or GroupNorm of ``gn_groups`` where
    ``use_gn`` -> ``act`` (GELU, or none). Names match the reference's
    ``{conv, bn}``; ``bn_momentum`` is torch's."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bn_eps: float = 1e-5,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = gelu,
                 bn_momentum: float = 0.1, use_gn: bool = False, gn_groups: int = 1):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("ConvBN takes odd kernels only")
        self.act = act
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, bias=False)
        self.bn = (GroupNorm(gn_groups, out_ch, eps=bn_eps) if use_gn
                   else BatchNorm(out_ch, eps=bn_eps, momentum=bn_momentum))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.conv.kernel_size[0] // 2
        x = self.bn(conv2d_nhwc(pad2d(x, p, p, p, p, mode="edge"), self.conv.weight))
        return x if self.act is None else self.act(x)


class EdgeConv(nn.Conv2d):
    """k x k conv (odd k; bias-free unless ``bias``; ``groups`` as
    ``nn.Conv2d``'s) after a (k // 2)-pixel replicate pad, on NHWC input,
    in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool = False,
                 groups: int = 1):
        if kernel_size % 2 != 1:
            raise ValueError("EdgeConv takes odd kernels only")
        super().__init__(in_ch, out_ch, kernel_size, bias=bias, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.kernel_size[0] // 2
        return conv2d_nhwc(pad2d(x, p, p, p, p, mode="edge"), self.weight, self.bias,
                           groups=self.groups)


class ValidConv(nn.Conv2d):
    """k x k VALID conv (at ``stride``, default 1) on NHWC input, in the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, stride=self.stride[0])


class Conv1x1(ValidConv):
    """1x1 conv on NHWC input, in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool):
        super().__init__(in_ch, out_ch, 1, bias=bias)


class ZeroPadConv(nn.Conv2d):
    """k x k conv (odd k) after a (k // 2)-pixel zero pad, on NHWC input, in
    the input's dtype: torch's ``nn.Conv2d(..., padding=k // 2)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True):
        if kernel_size % 2 != 1:
            raise ValueError("ZeroPadConv takes odd kernels only")
        super().__init__(in_ch, out_ch, kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, padding=self.kernel_size[0] // 2)
