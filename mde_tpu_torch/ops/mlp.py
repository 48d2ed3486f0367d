"""Feed-forward blocks (``mde_tpu/ops/mlp.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .depthwise import DepthwiseConv2d
from .kernels.glu_ff import glu_ff
from .tnn import BatchNorm, LayerNorm, Linear, bn_use_running_average, gelu


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
    BN -> GELU -> lin3 -> residual (``mde_tpu/ops/mlp.py:111-202``).

    ``ff_impl``: ``"auto"`` (the default) keeps this unfused path, the JAX
    module's default. ``"fused"`` (JAX's ``'pallas'``) runs gate, conv,
    BatchNorm folded to an affine and exact-erf GELU in one pass (kernel K4)
    whenever BatchNorm normalises with its running statistics: in eval mode
    or inside an active ``bn_freeze_scope`` (JAX's ``fused_ok``, :176-178).
    With batch statistics the unfused path runs. In bf16 the two paths differ
    by about a bf16 ulp: the fused GELU is exact erf, the unfused one
    ``tnn.gelu``'s tanh form."""

    FF_IMPLS = ("auto", "fused")

    def __init__(self, dim: int, feedforward_dims: Optional[int] = None,
                 kernel_size: int = 5, bn_eps: float = 1e-5, ff_impl: str = "auto"):
        super().__init__()
        hidden = feedforward_dims or 4 * dim
        self.ff_impl = ff_impl
        self.norm = LayerNorm(dim)
        self.lin1 = Linear(dim, 2 * hidden)
        self.conv2 = DepthwiseConv2d(hidden, kernel_size)
        self.bn2 = BatchNorm(hidden, eps=bn_eps)
        self.lin3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ff_impl not in self.FF_IMPLS:
            raise ValueError(f"ff_impl {self.ff_impl!r}: expected one of {self.FF_IMPLS}")
        ab = self.lin1(self.norm(x))
        if self.ff_impl == "fused" and bn_use_running_average(self.bn2):
            bn = self.bn2
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            t = bn.bias - bn.running_mean * s
            y = glu_ff(ab, self.conv2.kernel(ab.dtype), s, t)
        else:
            a, b = ab.chunk(2, dim=-1)
            y = gelu(self.bn2(self.conv2((a * torch.sigmoid(b)).contiguous())))
        return self.lin3(y) + x
