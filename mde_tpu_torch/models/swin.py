"""Swin Transformer backbone on NHWC tensors (``mde_tpu/models/swin.py``).

Parameter names follow the reference torch state dict
(``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``,
``layers.{i}.downsample.reduction``, ``norm{i}``), the names
``mde_tpu.core.checkpoint.convert_swin_backbone`` converts from.

``padding_mode`` pads the image to patch multiples, odd maps before a patch
merge and token maps to window multiples: ``"edge"`` repeats the border (the
ODA and ODA2 variants, the default), ``"zeros"`` pads with zeros (the
NewCRFs variant, torch ``F.pad``'s default).

``shift_collapse`` is timm's min-window rule (the ODA variant,
``mde_tpu/models/swin.py:113-121``): where a call's token grid is no larger
than the window on its shorter side, SW-MSA runs as W-MSA and the window
shrinks to that side. JAX sizes a block's rel-pos table from the window a
call gives it; here each stage's window, and so its table, is fixed at
build from ``input_size`` (the window where it is None), and a call whose
grid would need another window raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.attention import WindowAttention
from ..ops.drop import Dropout, DropPath
from ..ops.mlp import SwinMLP
from ..ops.pad import pad2d, pad_to_multiple
from ..ops.remat import checkpoint, tag_sa
from ..ops.tnn import LayerNorm, Linear, conv2d_nhwc
from ..ops.window import (cyclic_shift, cyclic_unshift, shifted_window_attn_mask,
                          window_partition, window_reverse)


class PatchEmbed(nn.Module):
    """p x p patchify conv + LayerNorm, after a pad to a multiple of p."""

    def __init__(self, patch_size: int = 4, in_ch: int = 3, embed_dim: int = 96,
                 padding_mode: str = "edge"):
        super().__init__()
        self.patch_size = patch_size
        self.padding_mode = padding_mode
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = conv2d_nhwc(pad_to_multiple(x, p, self.padding_mode), self.proj.weight,
                        self.proj.bias, stride=p)
        return self.norm(x)


class PatchMerging(nn.Module):
    """2x2 space-to-depth in the reference's order [x00, x10, x01, x11],
    then LayerNorm and Linear(4C -> 2C)."""

    def __init__(self, dim: int, padding_mode: str = "edge"):
        super().__init__()
        self.padding_mode = padding_mode
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = pad2d(x, 0, h % 2, 0, w % 2, self.padding_mode)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


DropMasks = Optional[Tuple[torch.Tensor, torch.Tensor]]


class SwinBlock(nn.Module):
    """[shift ->] window attention with rel-pos bias (and the SW-MSA mask)
    -> residual -> LN -> MLP -> residual. Windows are padded by
    ``padding_mode``. In training both residual branches go through
    stochastic depth, each with its own per-sample mask (``draw_masks``),
    and ``attn_drop_prob`` (the attention probabilities) and ``drop_prob``
    (the projection and both MLP outputs) drop elements, drawn from the
    ``generator``."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, path_drop_prob: float = 0.0,
                 padding_mode: str = "edge", drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0, shift_collapse: bool = False,
                 nominal_window: Optional[int] = None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.padding_mode = padding_mode
        # with shift_collapse, the stage's window before the min-window rule
        self.shift_collapse = shift_collapse
        self.nominal_window = nominal_window or window_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias, attn_drop_prob,
                                    drop_prob)
        self.drop_path = DropPath(path_drop_prob)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio), drop_prob)

    def draw_masks(self, batch: int, generator: Optional[torch.Generator],
                   device: torch.device) -> DropMasks:
        """The stochastic-depth keep masks of the attention and MLP branches
        for one call, or None where drop path is the identity."""
        attn = self.drop_path.draw(batch, generator, device)
        return None if attn is None else (attn, self.drop_path.draw(batch, generator, device))

    def drops(self) -> bool:
        """Whether a call in the current mode draws element-wise dropout."""
        return self.training and (self.attn.attn_drop.rate > 0 or self.mlp.drop.rate > 0)

    def window(self, h: int, w: int) -> Tuple[int, int]:
        """(window, shift) of a call on an h x w token grid; raises where
        the rule gives a window the block's table was not built for."""
        r, s = self.nominal_window, self.shift_size
        if self.shift_collapse and min(h, w) <= r:
            r, s = min(h, w), 0
        if r != self.window_size:
            raise ValueError(f"a {h}x{w} token grid takes window {r}; the block was built for "
                             f"window {self.window_size}: build the encoder for this input "
                             f"size")
        return r, s

    def forward(self, x: torch.Tensor, masks: DropMasks = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        r, s = self.window(h, w)
        keep_attn, keep_mlp = masks if masks is not None else (None, None)
        y = pad_to_multiple(self.norm1(x), r, self.padding_mode)
        hp, wp = y.shape[1], y.shape[2]
        mask = shifted_window_attn_mask(hp, wp, r, s, x.device) if s > 0 else None
        y = window_partition(cyclic_shift(y, s), r)
        y = cyclic_unshift(window_reverse(self.attn(y, mask, generator), r, hp, wp), s)
        # kept by a recomputing block under the save_sa policies (ops/remat.py)
        x = tag_sa(x + self.drop_path(y[:, :h, :w], keep_attn))
        return x + self.drop_path(self.mlp(self.norm2(x), generator), keep_mlp)


class SwinStage(nn.Module):
    """``depth`` blocks with alternating shift, then an optional patch merge.
    ``built_window`` (default ``window_size``) sizes the blocks' rel-pos
    tables, where ``shift_collapse`` shrinks the window at the built input
    size. Returns (stage output, input of the next stage). ``use_checkpoint``
    recomputes each block in the backward pass under the recompute policy
    (``ops/remat.py``); its
    drop-path masks are drawn before the block, once, and its dropout masks
    again from the same generator state."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 path_drop_probs: Sequence[float] = (), downsample: bool = False,
                 use_checkpoint: bool = False, padding_mode: str = "edge",
                 drop_prob: float = 0.0, attn_drop_prob: float = 0.0,
                 shift_collapse: bool = False, built_window: Optional[int] = None):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        pdp = list(path_drop_probs) + [0.0] * (depth - len(path_drop_probs))
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, built_window or window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias, pdp[i],
                      padding_mode, drop_prob, attn_drop_prob, shift_collapse, window_size)
            for i in range(depth))
        self.downsample = PatchMerging(dim, padding_mode) if downsample else None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for block in self.blocks:
            masks = block.draw_masks(x.shape[0], generator, x.device)
            if self.use_checkpoint and torch.is_grad_enabled():
                x = checkpoint(block, x, masks,
                               generator=generator if block.drops() else None)
            else:
                x = block(x, masks, generator)
        return x, (x if self.downsample is None else self.downsample(x))


class SwinTransformer(nn.Module):
    """4-stage backbone returning NHWC features at strides 4/8/16/32, each
    through its output LayerNorm ``norm{i}`` (none where ``out_norms`` is
    False: the ODA encoder). ``shift_collapse`` and ``input_size``: see the
    module docstring. Stochastic depth rises
    linearly over the blocks, ``path_drop_prob * i / (total - 1)``
    (``mde_tpu/models/swin.py:315``), drawn from the ``generator`` given to
    ``forward`` in training. ``frozen_stages`` >= 0 detaches the patch
    embedding's output, and each stage i with i + 1 < ``frozen_stages`` its
    outputs, where JAX stops the gradient (``:309-310,339-341``): the
    parameters before them get no gradient. ``drop_prob`` drops the patch
    embedding's output and, in every block, the attention's projection and
    the MLP's outputs; ``attn_drop_prob`` the attention probabilities
    (``:283``), both from the ``generator`` and 0 by default."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 path_drop_prob: float = 0.2, out_indices: Sequence[int] = (0, 1, 2, 3),
                 use_checkpoint: bool = False, frozen_stages: int = -1,
                 padding_mode: str = "edge", drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0, shift_collapse: bool = False,
                 input_size: Optional[Tuple[int, int]] = None, out_norms: bool = True):
        super().__init__()
        self.num_features = tuple(int(embed_dim * 2 ** i) for i in range(len(depths)))
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.out_norms = out_norms
        windows = [window_size] * len(depths)
        if shift_collapse and input_size is not None:
            h, w = -(-input_size[0] // patch_size), -(-input_size[1] // patch_size)
            for i in range(len(depths)):
                windows[i] = min(window_size, h, w)
                h, w = -(-h // 2), -(-w // 2)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim, padding_mode)
        self.pos_drop = Dropout(drop_prob)
        total = sum(depths)
        pdp = [path_drop_prob * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            start = sum(depths[:i])
            self.layers.append(SwinStage(
                self.num_features[i], depth, num_heads[i], window_size, mlp_ratio, qkv_bias,
                pdp[start:start + depth], downsample=i < len(depths) - 1,
                use_checkpoint=use_checkpoint, padding_mode=padding_mode, drop_prob=drop_prob,
                attn_drop_prob=attn_drop_prob, shift_collapse=shift_collapse,
                built_window=windows[i]))
        if out_norms:
            for i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(self.num_features[i]))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        if self.frozen_stages >= 0:
            x = x.detach()
        x = self.pos_drop(x, generator)
        outs = []
        for i, stage in enumerate(self.layers):
            x_out, x = stage(x, generator)
            if i + 1 < self.frozen_stages:
                x, x_out = x.detach(), x_out.detach()
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x_out) if self.out_norms else x_out)
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


def swin_encoder(encoder_type: str, **kwargs) -> SwinTransformer:
    """The encoder that an ODA2 model's ``encoder_type`` names: ``base``
    (``B``), ``large`` (``L``) or ``custom`` (every field from ``kwargs``)."""
    if encoder_type in ("base", "B"):
        return swin_base(**kwargs)
    if encoder_type in ("large", "L"):
        return swin_large(**kwargs)
    if encoder_type == "custom":
        return SwinTransformer(**kwargs)
    raise ValueError(f"Unsupported encoder type {encoder_type}.")
