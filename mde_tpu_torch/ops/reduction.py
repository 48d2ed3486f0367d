"""Reduction attention (``mde_tpu/ops/reduction.py``): the queries see every
pixel, the keys and values come from the r x r block means of the map, so
the logits are (HW, HW / r^2) a head.

The JAX package computes these attentions with plain einsums, outside any
Pallas kernel, so the port does too (``torch.einsum``, cuBLAS on the card),
in JAX's order: the logits in the activation dtype, then scaled, the
softmax in f32, cast back, dropout, then P . v.

Parameter names follow the reference torch state dict (``norm``,
``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``, and for the ordered SA
``mean_proj``, ``mean_norm``), the names
``mde_tpu.core.family_converters._plain_reduction_sa`` and
``_ordered_reduction_sa`` (``:599-607,737-742``) convert from.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .drop import Dropout
from .tnn import LayerNorm, Linear
from .window import cyclic_shift, cyclic_unshift


def block_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, C) means of r x r blocks, summed in
    f32 and cast back (``jnp.mean`` of bf16 does so)."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"a {h}x{w} map does not split into {r}x{r} blocks")
    return x.float().reshape(b, h // r, r, w // r, r, c).mean(dim=(2, 4)).to(x.dtype)


def sinusoidal_depth_embedding(num_emb: int, dims: int, base: float = 2000.0,
                               scaled: bool = True) -> torch.Tensor:
    """The fixed (num_emb, dims) f32 table sin | cos of pos * base^(-2i/dims),
    interleaved, scaled by sqrt(1/dims) unless ``scaled`` is False; the cls
    head's is base 1000, the red-Luna aux bank base 10000 unscaled."""
    emb = np.zeros((num_emb, dims), np.float32)
    pos = np.arange(num_emb, dtype=np.float32)
    inv_freq = np.exp(np.arange(0.0, dims, 2.0, dtype=np.float32) * (-math.log(base) / dims))
    pos_dot = np.outer(pos, inv_freq)
    emb[:, 0::2] = np.sin(pos_dot)
    emb[:, 1::2] = np.cos(pos_dot)
    if scaled:
        emb *= math.sqrt(1.0 / dims)
    return torch.from_numpy(emb)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           attn_drop: Dropout, generator: Optional[torch.Generator],
           scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v over (B, Nq, C) queries, (B, Nk, C) keys and
    (B, Nk, Cv) values split into ``num_heads``, in JAX's order: the logits
    in q's dtype times the scale (default (C / heads)^-0.5), the softmax in
    f32, its cast back to q's dtype, dropout, P . v. Returns ((B, Nq, Cv),
    the f32 softmax (B, heads, Nq, Nk))."""
    b, nq, c = q.shape
    if scale is None:
        scale = (c // num_heads) ** -0.5
    qh, kh, vh = (t.reshape(b, t.shape[1], num_heads, -1) for t in (q, k, v))
    attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * torch.tensor(scale, dtype=q.dtype)
    weights = attn.float().softmax(dim=-1)
    attn = attn_drop(weights.to(q.dtype), generator)
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, nq, v.shape[-1]), weights


class PreNormReductionSA(nn.Module):
    """Pre-norm residual reduction SA of ``oda2_red_reg``
    (``mde_tpu/ops/reduction.py:103-156``): the whole map is rolled before
    the norm, K and V come from the block means of the normed map, and the
    output is rolled back after ``o_proj`` and its dropout."""

    def __init__(self, dim: int, num_heads: int, reduction_ratio: int = 2,
                 shift_size: int = 0, attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        if reduction_ratio % 2 or dim % num_heads:
            raise ValueError(f"reduction ratio {reduction_ratio} (even) and {dim} channels "
                             f"over {num_heads} heads")
        self.num_heads = num_heads
        self.reduction_ratio = reduction_ratio
        self.shift_size = shift_size
        self.norm = LayerNorm(dim)
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.o_proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        xn = self.norm(cyclic_shift(x, self.shift_size))
        red = block_mean(xn, self.reduction_ratio).reshape(b, -1, c)
        out, _ = attend(self.q_proj(xn).reshape(b, h * w, c), self.k_proj(red),
                        self.v_proj(red), self.num_heads, self.attn_drop, generator)
        out = self.drop(self.o_proj(out.reshape(b, h, w, c)), generator)
        return cyclic_unshift(out, self.shift_size) + x


class PreNormOrderedReductionSA(PreNormReductionSA):
    """Pre-norm residual reduction SA of the ordered decoders
    (``mde_tpu/ops/reduction.py:47-100``): q from the normed map; K and V
    from ``mean_proj`` and ``mean_norm`` of the block means of the
    unnormed, optionally rolled map; no roll of the output. ``de`` is
    taken and unused, as in JAX (the reference's active code path does not
    mix it in)."""

    def __init__(self, dim: int, num_heads: int, reduction_ratio: int = 8,
                 shift_size: int = 0, attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__(dim, num_heads, reduction_ratio, shift_size, attn_drop_prob,
                         drop_prob)
        self.mean_proj = Linear(dim, dim, bias=False)
        self.mean_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, de: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        q = self.q_proj(self.norm(x)).reshape(b, h * w, c)
        red = block_mean(cyclic_shift(x, self.shift_size), self.reduction_ratio)
        red = self.mean_norm(self.mean_proj(red)).reshape(b, -1, c)
        out, _ = attend(q, self.k_proj(red), self.v_proj(red), self.num_heads, self.attn_drop,
                        generator)
        return self.drop(self.o_proj(out.reshape(b, h, w, c)), generator) + x
