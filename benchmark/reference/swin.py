"""Plain Swin Transformer encoder (Liu et al. 2021, arXiv:2103.14030) on
NHWC tensors, as both configurations run it.

Tokens are padded with their border to window multiples, shifted windows
take the -100 region mask of the padded map, and each stage's window is
fixed at build (``shift_collapse``: where a stage's token grid is no
taller or wider than the window, the window shrinks to that side and the
blocks do not shift; the ODA encoder). In training every block draws,
in this order: the stochastic-depth keep masks of its attention and MLP
branches (one value an image), then the element-wise dropout masks of the
attention's projection and the MLP's two outputs. ``checkpoint``
recomputes each block in the backward pass with the masks it drew.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (Dropout, LayerNorm, Linear, Numerics, apply_keep, attend, conv2d,
                     gelu, keep_mask, pad_edge, pad_to, relative_index, shift, shift_mask,
                     unshift, unwindows, windows)


class PatchEmbed(nn.Module):
    def __init__(self, num: Numerics, dim: int, patch: int = 4):
        super().__init__()
        self.num, self.patch = num, patch
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.zeros(dim, 3, patch, patch))
        self.proj.bias = nn.Parameter(torch.zeros(dim))
        self.norm = LayerNorm(num, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_to(x, self.patch)
        return self.norm(conv2d(self.num, x, self.proj.weight, self.proj.bias, self.patch))


class WindowAttention(nn.Module):
    def __init__(self, num: Numerics, dim: int, heads: int, window: int, drop: float):
        super().__init__()
        self.num, self.heads, self.window = num, heads, window
        self.qkv = Linear(num, dim, 3 * dim)
        self.proj = Linear(num, dim, dim)
        self.proj_drop = Dropout(drop)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x, mask, proj_keep):
        bw, n, c = x.shape
        idx = relative_index(self.window, x.device)
        bias = self.relative_position_bias_table[idx].permute(2, 0, 1).float()
        add = bias if mask is None else bias[None] + mask[:, None]
        q, k, v = self.qkv(x).split(c, dim=-1)
        out = self.proj(attend(self.num, q, k, v, self.heads, (c // self.heads) ** -0.5, add))
        return apply_keep(out, proj_keep, self.proj_drop.rate)


class Mlp(nn.Module):
    def __init__(self, num: Numerics, dim: int, hidden: int, drop: float):
        super().__init__()
        self.fc1 = Linear(num, dim, hidden)
        self.fc2 = Linear(num, hidden, dim)
        self.drop = Dropout(drop)

    def forward(self, x, keep1, keep2):
        y = apply_keep(gelu(self.fc1(x)), keep1, self.drop.rate)
        return apply_keep(self.fc2(y), keep2, self.drop.rate)


class SwinBlock(nn.Module):
    def __init__(self, num: Numerics, dim: int, heads: int, window: int, shift_size: int,
                 path_rate: float, drop: float):
        super().__init__()
        self.window, self.shift_size, self.path_rate = window, shift_size, path_rate
        self.norm1 = LayerNorm(num, dim)
        self.attn = WindowAttention(num, dim, heads, window, drop)
        self.norm2 = LayerNorm(num, dim)
        self.mlp = Mlp(num, dim, 4 * dim, drop)

    def draw(self, x: torch.Tensor, generator) -> Tuple[Optional[torch.Tensor], ...]:
        """The block's masks, in the order the program draws them."""
        if not self.training:
            return (None,) * 5
        b, h, w, c = x.shape
        r = self.window
        hp, wp = h + (-h) % r, w + (-w) % r
        path = [keep_mask((b,), self.path_rate, generator, x.device) if self.path_rate > 0
                else None for _ in range(2)]
        rate = self.attn.proj_drop.rate
        if rate == 0:
            return (*path, None, None, None)
        shapes = [(b * (hp // r) * (wp // r), r * r, c), (b, h, w, 4 * c), (b, h, w, c)]
        return (*path, *(keep_mask(s, rate, generator, x.device) for s in shapes))

    def forward(self, x, path_attn, path_mlp, proj_keep, mlp_keep1, mlp_keep2):
        _, h, w, _ = x.shape
        r, s = self.window, self.shift_size
        y = pad_to(self.norm1(x), r)
        hp, wp = y.shape[1], y.shape[2]
        mask = shift_mask(hp, wp, r, s, x.device) if s > 0 else None
        y = self.attn(windows(shift(y, s), r), mask, proj_keep)
        y = unshift(unwindows(y, r, hp, wp), s)[:, :h, :w]
        x = x + apply_keep(y, path_attn, self.path_rate)
        y = self.mlp(self.norm2(x), mlp_keep1, mlp_keep2)
        return x + apply_keep(y, path_mlp, self.path_rate)


class PatchMerging(nn.Module):
    def __init__(self, num: Numerics, dim: int):
        super().__init__()
        self.norm = LayerNorm(num, 4 * dim)
        self.reduction = Linear(num, 4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_edge(x, x.shape[1] % 2, x.shape[2] % 2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, num, dim, depth, heads, window, shift_size, path_rates, drop,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(num, dim, heads, window, 0 if i % 2 == 0 else shift_size,
                      path_rates[i], drop) for i in range(depth))
        self.downsample = PatchMerging(num, dim) if downsample else None


class SwinEncoder(nn.Module):
    """Four stages at strides 4 to 32. ``input_hw`` (after any resize) fixes
    each stage's window under ``shift_collapse``. ``out_norms`` puts each
    output through LayerNorm ``norm{i}``."""

    def __init__(self, num: Numerics, embed: int, depths: Sequence[int],
                 heads: Sequence[int], window: int, path_rate: float, drop: float,
                 input_hw: Tuple[int, int], shift_collapse: bool, out_norms: bool,
                 checkpoint_blocks: bool):
        super().__init__()
        self.checkpoint_blocks = checkpoint_blocks
        self.out_norms = out_norms
        self.patch_embed = PatchEmbed(num, embed)
        self.pos_drop = Dropout(drop)
        total = sum(depths)
        rates = [path_rate * i / max(total - 1, 1) for i in range(total)]
        h, w = -(-input_hw[0] // 4), -(-input_hw[1] // 4)
        self.layers = nn.ModuleList()
        dims = [embed * 2 ** i for i in range(len(depths))]
        for i, depth in enumerate(depths):
            r, s = window, window // 2
            if shift_collapse and min(h, w) <= window:
                r, s = min(h, w), 0
            start = sum(depths[:i])
            self.layers.append(SwinStage(num, dims[i], depth, heads[i], r, s,
                                         rates[start:start + depth], drop,
                                         i < len(depths) - 1))
            h, w = -(-h // 2), -(-w // 2)
        if out_norms:
            for i, d in enumerate(dims):
                self.add_module(f"norm{i}", LayerNorm(num, d))

    def forward(self, x: torch.Tensor, generator=None) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        x = self.pos_drop(x, generator)
        outs = []
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                masks = block.draw(x, generator)
                if self.checkpoint_blocks and torch.is_grad_enabled():
                    x = checkpoint(block, x, *masks, use_reentrant=False)
                else:
                    x = block(x, *masks)
            outs.append(getattr(self, f"norm{i}")(x) if self.out_norms else x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
