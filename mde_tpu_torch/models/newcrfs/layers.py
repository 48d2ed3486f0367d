"""NewCRFs decoder layers, neural-window fully-connected CRFs
(``mde_tpu/models/newcrfs/layers.py``).

Window attention whose q and k come from the image features (one fused
``qk`` projection) and whose v is the previous, coarser depth estimate:
attention as learned CRF message passing over the estimate. Blocks
alternate W-MSA and SW-MSA as in Swin; each NewCRF stage is two blocks and
an output LayerNorm. The attention runs through kernel K1's q|k + separate-v
entry (``ops/kernels/window_attention.window_attention_qk_v``).

Parameter names follow the reference torch state dict (``proj_x``,
``proj_v``, ``crf_layer.blocks.{j}.attn.qk``, ``norm_crf``), the names
``mde_tpu.core.checkpoint.convert_newcrfs_model`` converts from.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.attention import dropout_window_attention, relative_position_index
from ...ops.conv import ZeroPadConv
from ...ops.drop import Dropout
from ...ops.init import trunc_normal_
from ...ops.kernels.window_attention import window_attention_qk_v
from ...ops.mlp import SwinMLP
from ...ops.pad import pad_to_multiple
from ...ops.tnn import LayerNorm, Linear
from ...ops.window import (cyclic_shift, cyclic_unshift, shifted_window_attn_mask,
                           window_partition, window_reverse)


class CRFWindowAttention(nn.Module):
    """Window attention over (B*nW, N, C) windows with q and k from ``x``
    and v given (``layers.py:33-96``), rel-pos bias and the optional SW-MSA
    mask, then ``proj``. In training with ``attn_drop_prob`` > 0 the
    probabilities go through dropout on JAX's einsum path
    (``ops.attention.dropout_window_attention``, ``layers.py:76-96``), as
    JAX's module does; otherwise kernel K1 computes the attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"{dim} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.window_size = window_size
        self.qk = Linear(dim, 2 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        rpi = relative_position_index(window_size, window_size)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rpi.reshape(-1)), persistent=False)
        self.proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.proj_drop = Dropout(drop_prob)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.relative_position_bias_table.data, 0.02, generator)

    def forward(self, x: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bw, n, c = x.shape
        if v.shape != x.shape:
            raise ValueError(f"v {tuple(v.shape)} must match x {tuple(x.shape)} (reference "
                             f"``:143``)")
        nh = self.num_heads
        scale = (c // nh) ** -0.5
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1).contiguous()  # (nh, N, N) f32
        qk = self.qk(x)
        if self.training and self.attn_drop.rate > 0:
            q, k = qk.reshape(bw, n, 2, nh, c // nh).unbind(2)
            out = dropout_window_attention(q, k, v.reshape(bw, n, nh, c // nh), bias, mask,
                                           scale, self.attn_drop, generator)
        else:
            out = window_attention_qk_v(qk, v, bias, mask, nh, scale)
        return self.proj_drop(self.proj(out), generator)

class CRFBlock(nn.Module):
    """One CRF message-passing block (``layers.py:99-150``): LN, x and v both
    zero-padded to window multiples, shifted together and partitioned, the
    SW-MSA mask built on the padded grid, CRF window attention, residual, LN,
    MLP, residual. ``drop_prob`` drops the attention's projection and both
    MLP outputs, as JAX's block does (NewCRF builds its blocks at rate 0)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = CRFWindowAttention(dim, num_heads, window_size, qkv_bias, attn_drop_prob,
                                       drop_prob)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio), drop_prob)

    def forward(self, x: torch.Tensor, v: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        r, s = self.window_size, self.shift_size
        y = pad_to_multiple(self.norm1(x), r, "zeros")
        v = pad_to_multiple(v, r, "zeros")
        hp, wp = y.shape[1], y.shape[2]
        mask = shifted_window_attn_mask(hp, wp, r, s, x.device) if s > 0 else None
        yw = window_partition(cyclic_shift(y, s), r)
        vw = window_partition(cyclic_shift(v, s), r)
        y = cyclic_unshift(window_reverse(self.attn(yw, vw, mask, generator), r, hp, wp), s)
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x), generator)


class BasicCRFLayer(nn.Module):
    """The blocks of one NewCRF stage, shift 0 and r // 2 in turn (the
    reference's ``crf_layer``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.blocks = nn.ModuleList(
            CRFBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2)
            for i in range(depth))

    def forward(self, x: torch.Tensor, v: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, v, generator)
        return x


class NewCRF(nn.Module):
    """One NewCRF stage (``layers.py:153-179``): a 3x3 ``proj_x`` and
    ``proj_v`` (zero padding) only where the input widths differ from
    ``embed_dim``, ``depth`` CRF blocks, then ``norm_crf``."""

    def __init__(self, in_dim: int, v_dim: int, embed_dim: int, num_heads: int,
                 window_size: int = 7, depth: int = 2):
        super().__init__()
        self.proj_x = ZeroPadConv(in_dim, embed_dim, 3) if in_dim != embed_dim else None
        self.proj_v = ZeroPadConv(v_dim, embed_dim, 3) if v_dim != embed_dim else None
        self.crf_layer = BasicCRFLayer(embed_dim, depth, num_heads, window_size)
        self.norm_crf = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, v: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.proj_x is not None:
            x = self.proj_x(x)
        if self.proj_v is not None:
            v = self.proj_v(v)
        return self.norm_crf(self.crf_layer(x, v, generator))
