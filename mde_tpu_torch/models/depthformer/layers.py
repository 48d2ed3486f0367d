"""Depthformer's shared layers (``mde_tpu/models/depthformer/layers.py``):
ConvBN with replicate padding and an identity residual, its stacks, the
bilinear upscale-concat, and the pre-norm ViT layer whose self-attention
has its own ``key_query_dim`` and returns its f32 weights.

The self-attention is plain einsums, as JAX's is (``ops/reduction.attend``:
the logits in the activation dtype, then scaled, the softmax in f32, cast
back, dropout per element, P . v): no kernel of the port lies on it.

Parameter names follow the reference torch modules, the names the JAX
package's ``_df_convbn``, ``_df_convbnblock``, ``_df_resblock``,
``_df_sa``, ``_df_ff`` and ``_df_vit``
(``mde_tpu/core/family_converters.py:30-84``) convert from: ``conv``,
``bn``; ``layers.{j}``, ``shortcut``; ``norm``, ``{query,key,value,out}_proj``;
``norm``, ``fc1``, ``fc2``; ``self_attn``, ``feed_forward``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ...ops import conv
from ...ops.drop import Dropout
from ...ops.reduction import attend
from ...ops.resize import upsample2d
from ...ops.tnn import LayerNorm, Linear, gelu

Act = Optional[Callable[[torch.Tensor], torch.Tensor]]


class ConvBN(conv.ConvBN):
    """Replicate pad, bias-free k x k conv, BatchNorm, ``act``; plus the
    input where ``use_residual`` and the widths are equal
    (``layers.py:29-60``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, act: Act = None,
                 use_residual: bool = True, bn_momentum: float = 0.1):
        super().__init__(in_ch, out_ch, kernel_size, act=act, bn_momentum=bn_momentum)
        self.residual = use_residual and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y + x if self.residual else y


class ConvBNBlock(nn.Module):
    """``num_layers`` ConvBNs with ``act`` (GELU) and residuals
    (``layers.py:63-79``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, num_layers: int = 2,
                 act: Act = gelu):
        super().__init__()
        self.layers = nn.Sequential(*(ConvBN(in_ch if i == 0 else out_ch, out_ch, kernel_size,
                                             act=act) for i in range(num_layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class ResConvBNBlock(nn.Module):
    """ConvBNs without residuals, ``act`` (GELU) after all but the last,
    plus the input or, where the widths differ, a 1x1 ConvBN ``shortcut``
    of it (``layers.py:82-104``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, num_layers: int = 2,
                 act: Act = gelu):
        super().__init__()
        self.layers = nn.Sequential(*(
            ConvBN(in_ch if i == 0 else out_ch, out_ch, kernel_size,
                   act=act if i != num_layers - 1 else None, use_residual=False)
            for i in range(num_layers)))
        self.shortcut = (ConvBN(in_ch, out_ch, 1, use_residual=False) if in_ch != out_ch
                         else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x) + (x if self.shortcut is None else self.shortcut(x))


def upscale_concat_act(x_orig: torch.Tensor, y_to_upscale: torch.Tensor, scale: int,
                       act: Act = gelu) -> torch.Tensor:
    """Bilinear x``scale`` (align corners) of ``y_to_upscale``, concatenated
    after ``x_orig``, then ``act`` (``layers.py:107-112``)."""
    out = torch.cat([x_orig, upsample2d(y_to_upscale, scale)], dim=-1)
    return act(out) if act is not None else out


class SelfAttentionBlock(nn.Module):
    """Pre-norm residual multi-head self-attention over (B, N, dim) tokens,
    q and k of ``key_query_dim`` (default ``dim``), scaled by
    (key_query_dim / heads)^-0.5 after the product; dropout on the
    probabilities (``attn_drop_prob``) and on the output (``drop_prob``).
    Returns (tokens, the (B, heads, N, N) f32 softmax)
    (``layers.py:115-161``)."""

    def __init__(self, dim: int, key_query_dim: Optional[int] = None, num_heads: int = 4,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1):
        super().__init__()
        kq = key_query_dim or dim
        if dim % num_heads or kq % num_heads:
            raise ValueError(f"{dim} and {kq} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.scale = (kq // num_heads) ** -0.5
        self.norm = LayerNorm(dim)
        self.query_proj = Linear(dim, kq)
        self.key_proj = Linear(dim, kq)
        self.value_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        xn = self.norm(x)
        out, weights = attend(self.query_proj(xn), self.key_proj(xn), self.value_proj(xn),
                              self.num_heads, self.attn_drop, generator, self.scale)
        return self.drop(self.out_proj(out), generator) + x, weights


class FeedForwardBlock(nn.Module):
    """Residual FF: ``fc1`` to ``feedforward_dim`` (default 4 x dim),
    ``act`` (GELU), dropout, ``fc2``, dropout; ``norm`` before ``fc1``, or
    after the residual where ``post_norm`` (``layers.py:164-192``)."""

    def __init__(self, dim: int, feedforward_dim: Optional[int] = None, drop_prob: float = 0.1,
                 act: Callable[[torch.Tensor], torch.Tensor] = gelu, post_norm: bool = False):
        super().__init__()
        hidden = feedforward_dim or 4 * dim
        self.act = act
        self.post_norm = post_norm
        self.norm = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.drop(self.act(self.fc1(x if self.post_norm else self.norm(x))), generator)
        out = x + self.drop(self.fc2(y), generator)
        return self.norm(out) if self.post_norm else out


class ViTLayer(nn.Module):
    """``num_repeat`` times the same self-attention and FF (one set of
    weights, the FF's activation ``act``); returns (tokens, the last
    repeat's attention weights) (``layers.py:195-221``)."""

    def __init__(self, dim: int, key_query_dim: Optional[int] = None, num_heads: int = 4,
                 num_repeat: int = 1, feedforward_dim: Optional[int] = None,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1,
                 act: Callable[[torch.Tensor], torch.Tensor] = gelu):
        super().__init__()
        self.num_repeat = num_repeat
        self.self_attn = SelfAttentionBlock(dim, key_query_dim, num_heads, attn_drop_prob,
                                            drop_prob)
        self.feed_forward = FeedForwardBlock(dim, feedforward_dim, drop_prob, act)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for _ in range(self.num_repeat):
            x, weights = self.self_attn(x, generator)
            x = self.feed_forward(x, generator)
        return x, weights
