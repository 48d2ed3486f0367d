"""Window attention with relative position bias (``mde_tpu/ops/attention.py``)."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from .init import trunc_normal_
from .kernels.window_attention import window_attention
from .tnn import Linear


@functools.lru_cache(maxsize=None)
def relative_position_index(win_h: int, win_w: int) -> np.ndarray:
    """(N, N) lookup into the (2wh-1)*(2ww-1) rel-pos bias table."""
    coords = np.stack(np.meshgrid(np.arange(win_h), np.arange(win_w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += win_h - 1
    rel[:, :, 1] += win_w - 1
    rel[:, :, 0] *= 2 * win_w - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA over (B*nW, N, C) windows, N = window_size**2, through
    kernel K1. ``mask``: optional (nW, N, N) additive 0/-100 mask."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        rpi = relative_position_index(window_size, window_size)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rpi.reshape(-1)), persistent=False)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.relative_position_bias_table.data, 0.02, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bw, n, c = x.shape
        nh = self.num_heads
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1).contiguous()  # (nh, N, N) f32
        out = window_attention(self.qkv(x), bias, mask, nh, (c // nh) ** -0.5)
        return self.proj(out)
