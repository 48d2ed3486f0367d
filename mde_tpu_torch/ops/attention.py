"""Window attention with relative position bias (``mde_tpu/ops/attention.py``)."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from .drop import Dropout
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


def dropout_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor], scale: float,
                             attn_drop: Dropout,
                             generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX modules' einsum path, which they take in training with
    attention dropout (``mde_tpu/ops/attention.py:97-115``): over (BW, N,
    heads, hd) q, k, v, the logits of q * scale and k in the activation
    dtype, the (heads, N, N) bias and the (nW, N, N) mask added there,
    softmax in f32, cast back, dropout, then P . v; (BW, N, heads * hd)."""
    bw, n, nh, hd = v.shape
    attn = torch.einsum("bqhd,bkhd->bhqk", q * torch.tensor(scale, dtype=q.dtype), k)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bw // nw, nw, nh, n, n) + mask.to(attn.dtype)[None, :, None]
                ).reshape(bw, nh, n, n)
    attn = attn_drop(attn.float().softmax(dim=-1).to(v.dtype), generator)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bw, n, nh * hd)


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA over (B*nW, N, C) windows, N = window_size**2, through
    kernel K1, then ``proj`` and its dropout (``drop_prob``). ``mask``:
    optional (nW, N, N) additive 0/-100 mask. In training with
    ``attn_drop_prob`` > 0 the probabilities go through dropout on JAX's
    einsum path (:func:`dropout_window_attention`), where the JAX module
    leaves its kernel too."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.proj_drop = Dropout(drop_prob)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        rpi = relative_position_index(window_size, window_size)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rpi.reshape(-1)), persistent=False)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.relative_position_bias_table.data, 0.02, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bw, n, c = x.shape
        nh = self.num_heads
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1).contiguous()  # (nh, N, N) f32
        qkv = self.qkv(x)
        if self.training and self.attn_drop.rate > 0:
            q, k, v = qkv.reshape(bw, n, 3, nh, c // nh).unbind(2)
            out = dropout_window_attention(q, k, v, bias, mask, (c // nh) ** -0.5,
                                           self.attn_drop, generator)
        else:
            out = window_attention(qkv, bias, mask, nh, (c // nh) ** -0.5)
        return self.proj_drop(self.proj(out), generator)
