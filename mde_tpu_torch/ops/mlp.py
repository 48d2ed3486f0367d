"""Feed-forward blocks (``mde_tpu/ops/mlp.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .depthwise import DepthwiseConv2d
from .tnn import BatchNorm, LayerNorm, Linear, gelu


class SwinMLP(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class PreNormDWConvFF(nn.Module):
    """Pre-norm GLU + depthwise-conv feed-forward on (B, H, W, C):
    LN -> lin1 -> a * sigmoid(b) -> 5x5 depthwise conv (kernel K3) ->
    BN -> GELU -> lin3 -> residual. This is the JAX module's default,
    unfused path (``mde_tpu/ops/mlp.py:190-201``), the one BN in training
    mode takes."""

    def __init__(self, dim: int, feedforward_dims: Optional[int] = None,
                 kernel_size: int = 5, bn_eps: float = 1e-5):
        super().__init__()
        hidden = feedforward_dims or 4 * dim
        self.norm = LayerNorm(dim)
        self.lin1 = Linear(dim, 2 * hidden)
        self.conv2 = DepthwiseConv2d(hidden, kernel_size)
        self.bn2 = BatchNorm(hidden, eps=bn_eps)
        self.lin3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.lin1(self.norm(x)).chunk(2, dim=-1)
        y = self.conv2((a * torch.sigmoid(b)).contiguous())
        y = gelu(self.bn2(y))
        return self.lin3(y) + x
