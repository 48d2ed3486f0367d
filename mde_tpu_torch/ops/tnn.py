"""Layers with the JAX package's numerics (``mde_tpu/ops/tnn.py``).

Parameters are kept in f32; each layer computes in the dtype of its input,
so a model runs in bf16 by casting its input once, as the JAX modules'
``dtype`` field does. LayerNorm's eps is 1e-5 (torch's), and GELU follows
the JAX dtype rule: exact erf in f32, the tanh form in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, or its tanh form for bf16 input (``tnn.gelu``)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Linear(nn.Linear):
    """``nn.Linear`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, eps 1e-5, in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm over the last (channel) dim of NHWC ``x`` with running
    statistics, in f32 and cast back, in the order flax computes it:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x.float() - bn.running_mean) * mul + bn.bias).to(x.dtype)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride: int = 1) -> torch.Tensor:
    """VALID convolution of NHWC ``x`` with an OIHW weight, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)
