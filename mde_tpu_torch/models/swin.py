"""Swin Transformer backbone on NHWC tensors (``mde_tpu/models/swin.py``).

Parameter names follow the reference torch state dict
(``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``,
``layers.{i}.downsample.reduction``, ``norm{i}``), the names
``mde_tpu.core.checkpoint.convert_swin_backbone`` converts from.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.attention import WindowAttention
from ..ops.drop import DropPath
from ..ops.mlp import SwinMLP
from ..ops.pad import pad2d, pad_to_multiple
from ..ops.remat import checkpoint
from ..ops.tnn import LayerNorm, Linear, conv2d_nhwc
from ..ops.window import (cyclic_shift, cyclic_unshift, shifted_window_attn_mask,
                          window_partition, window_reverse)


class PatchEmbed(nn.Module):
    """p x p patchify conv + LayerNorm, after an edge pad to a multiple of p."""

    def __init__(self, patch_size: int = 4, in_ch: int = 3, embed_dim: int = 96):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = conv2d_nhwc(pad_to_multiple(x, p), self.proj.weight, self.proj.bias, stride=p)
        return self.norm(x)


class PatchMerging(nn.Module):
    """2x2 space-to-depth in the reference's order [x00, x10, x01, x11],
    then LayerNorm and Linear(4C -> 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = pad2d(x, 0, h % 2, 0, w % 2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


DropMasks = Optional[Tuple[torch.Tensor, torch.Tensor]]


class SwinBlock(nn.Module):
    """[shift ->] window attention with rel-pos bias (and the SW-MSA mask)
    -> residual -> LN -> MLP -> residual. Windows are edge-padded. In
    training both residual branches go through stochastic depth, each with
    its own per-sample mask (``draw_masks``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, path_drop_prob: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias)
        self.drop_path = DropPath(path_drop_prob)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio))

    def draw_masks(self, batch: int, generator: Optional[torch.Generator],
                   device: torch.device) -> DropMasks:
        """The stochastic-depth keep masks of the attention and MLP branches
        for one call, or None where drop path is the identity."""
        attn = self.drop_path.draw(batch, generator, device)
        return None if attn is None else (attn, self.drop_path.draw(batch, generator, device))

    def forward(self, x: torch.Tensor, masks: DropMasks = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        r, s = self.window_size, self.shift_size
        keep_attn, keep_mlp = masks if masks is not None else (None, None)
        y = pad_to_multiple(self.norm1(x), r)
        hp, wp = y.shape[1], y.shape[2]
        mask = shifted_window_attn_mask(hp, wp, r, s, x.device) if s > 0 else None
        y = window_partition(cyclic_shift(y, s), r)
        y = cyclic_unshift(window_reverse(self.attn(y, mask), r, hp, wp), s)
        x = x + self.drop_path(y[:, :h, :w], keep_attn)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep_mlp)


class SwinStage(nn.Module):
    """``depth`` blocks with alternating shift, then an optional patch merge.
    Returns (stage output, input of the next stage). ``use_checkpoint``
    recomputes each block in the backward pass (``ops/remat.py``); its
    drop-path masks are drawn before the block, once."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 path_drop_probs: Sequence[float] = (), downsample: bool = False,
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        pdp = list(path_drop_probs) + [0.0] * (depth - len(path_drop_probs))
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio, qkv_bias, pdp[i]) for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for block in self.blocks:
            masks = block.draw_masks(x.shape[0], generator, x.device)
            if self.use_checkpoint and torch.is_grad_enabled():
                x = checkpoint(block, x, masks)
            else:
                x = block(x, masks)
        return x, (x if self.downsample is None else self.downsample(x))


class SwinTransformer(nn.Module):
    """4-stage backbone returning NHWC features at strides 4/8/16/32, each
    through its output LayerNorm ``norm{i}``. Stochastic depth rises
    linearly over the blocks, ``path_drop_prob * i / (total - 1)``
    (``mde_tpu/models/swin.py:315``), drawn from the ``generator`` given to
    ``forward`` in training."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 path_drop_prob: float = 0.2, out_indices: Sequence[int] = (0, 1, 2, 3),
                 use_checkpoint: bool = False):
        super().__init__()
        self.num_features = tuple(int(embed_dim * 2 ** i) for i in range(len(depths)))
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        total = sum(depths)
        pdp = [path_drop_prob * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            start = sum(depths[:i])
            self.layers.append(SwinStage(
                self.num_features[i], depth, num_heads[i], window_size, mlp_ratio, qkv_bias,
                pdp[start:start + depth], downsample=i < len(depths) - 1,
                use_checkpoint=use_checkpoint))
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(self.num_features[i]))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.layers):
            x_out, x = stage(x, generator)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x_out))
        return tuple(outs)


def swin_base(**kwargs) -> SwinTransformer:
    """Swin-B: embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32)."""
    kwargs.setdefault("embed_dim", 128)
    kwargs.setdefault("depths", (2, 2, 18, 2))
    kwargs.setdefault("num_heads", (4, 8, 16, 32))
    return SwinTransformer(**kwargs)


def swin_large(**kwargs) -> SwinTransformer:
    """Swin-L: embed 192, depths (2, 2, 18, 2), heads (6, 12, 24, 48)."""
    kwargs.setdefault("embed_dim", 192)
    kwargs.setdefault("depths", (2, 2, 18, 2))
    kwargs.setdefault("num_heads", (6, 12, 24, 48))
    return SwinTransformer(**kwargs)


def swin_tiny(**kwargs) -> SwinTransformer:
    """Swin-T: embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24)."""
    kwargs.setdefault("embed_dim", 96)
    kwargs.setdefault("depths", (2, 2, 6, 2))
    kwargs.setdefault("num_heads", (3, 6, 12, 24))
    return SwinTransformer(**kwargs)
