"""Luna, linear unified nested attention (``mde_tpu/ops/luna.py``): a bank
of aux tokens attends over the pixels (attn1), then the pixels attend over
the updated aux tokens (attn2), linear in the pixel count.

- ``LunaBlock``: post-norm. attn2's keys and values come from attn1's
  output before its residual (``out1``), as in JAX.
- ``PreNormLunaBlock``: pre-norm; attn2 reads ``inter_norm(out1)``.
- ``LunaHalfBlock``: attn1 alone over an NHWC map; returns (aux, attn1).
- ``LunaLayer``: a block and the Depthformer ``FeedForwardBlock`` (post-norm
  where the block is).

Both attentions scale the logits by (hidden_dim // heads)^-0.5, whatever
``qk_proj_dim`` is (the reference's quirk, ``:8-9,63``). They are plain
einsums in JAX, so they are here (``ops/reduction.attend``: the logits in
the activation dtype, then scaled, the softmax in f32, returned, and cast
back, dropout, P . v): no kernel of the port lies on them.

Parameter names follow the reference torch modules, the names
``mde_tpu.core.family_converters._luna_block`` and ``_luna_layer``
(``:87-117``) convert from: ``{q,k,v,o}{1,2}_proj``, ``aux_norm``,
``norm``, ``inter_norm``; ``luna_attn``, ``feed_forward``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .drop import Dropout
from .reduction import attend
from .tnn import LayerNorm, Linear, gelu

Attns = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class _LunaCore(nn.Module):
    """attn1 (aux queries over ``dim``-channel pixels, output to
    ``aux_dim``) and, unless ``half``, attn2 (pixel queries over
    ``aux_dim``-channel aux tokens), each followed by its projection's
    dropout."""

    def __init__(self, dim: int, aux_dim: int, qk_proj_dim: int, num_heads: int,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1, half: bool = False):
        super().__init__()
        if dim % num_heads or qk_proj_dim % num_heads:
            raise ValueError(f"{dim} and {qk_proj_dim} channels do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.q1_proj = Linear(aux_dim, qk_proj_dim)
        self.k1_proj = Linear(dim, qk_proj_dim)
        self.v1_proj = Linear(dim, dim)
        self.o1_proj = Linear(dim, aux_dim)
        self.aux_norm = LayerNorm(aux_dim)
        if not half:
            self.q2_proj = Linear(dim, qk_proj_dim)
            self.k2_proj = Linear(aux_dim, qk_proj_dim)
            self.v2_proj = Linear(aux_dim, dim)
            self.o2_proj = Linear(dim, dim)
            self.norm = LayerNorm(dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def _attn1(self, hidden: torch.Tensor, aux: torch.Tensor, generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        out, attn = attend(self.q1_proj(aux), self.k1_proj(hidden), self.v1_proj(hidden),
                           self.num_heads, self.attn_drop, generator, self.scale)
        return self.drop(self.o1_proj(out), generator), attn

    def _attn2(self, hidden: torch.Tensor, kv: torch.Tensor, generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        out, attn = attend(self.q2_proj(hidden), self.k2_proj(kv), self.v2_proj(kv),
                           self.num_heads, self.attn_drop, generator, self.scale)
        return self.drop(self.o2_proj(out), generator), attn


class LunaBlock(_LunaCore):
    """Post-norm Luna over (B, N, dim) pixels and (B, K, aux_dim) aux
    tokens (``luna.py:55-85``): returns (pixels, aux, attn1, attn2)."""

    def forward(self, hidden: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Attns:
        out1, attn1 = self._attn1(hidden, aux, generator)
        aux_out = self.aux_norm(aux + out1)
        out2, attn2 = self._attn2(hidden, out1, generator)
        return self.norm(hidden + out2), aux_out, attn1, attn2


class PreNormLunaBlock(_LunaCore):
    """Pre-norm Luna (``luna.py:88-121``): ``aux_norm`` and ``norm`` before
    attn1, ``inter_norm`` on attn1's output before attn2; returns (pixels,
    aux, attn1, attn2)."""

    def __init__(self, dim: int, aux_dim: int, qk_proj_dim: int, num_heads: int,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1):
        super().__init__(dim, aux_dim, qk_proj_dim, num_heads, attn_drop_prob, drop_prob)
        self.inter_norm = LayerNorm(aux_dim)

    def forward(self, hidden: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Attns:
        hidden_n = self.norm(hidden)
        out1, attn1 = self._attn1(hidden_n, self.aux_norm(aux), generator)
        out2, attn2 = self._attn2(hidden_n, self.inter_norm(out1), generator)
        return hidden + out2, aux + out1, attn1, attn2


class LunaHalfBlock(_LunaCore):
    """attn1 alone over an NHWC map (``luna.py:124-144``): returns
    (aux_norm(aux + out1), attn1)."""

    def __init__(self, dim: int, aux_dim: int, qk_proj_dim: int, num_heads: int,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1):
        super().__init__(dim, aux_dim, qk_proj_dim, num_heads, attn_drop_prob, drop_prob,
                         half=True)

    def forward(self, hidden_nhwc: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, d = hidden_nhwc.shape
        out1, attn1 = self._attn1(hidden_nhwc.reshape(b, h * w, d), aux, generator)
        return self.aux_norm(aux + out1), attn1


class LunaLayer(nn.Module):
    """A Luna block (``PreNormLunaBlock`` where ``pre_norm``, else
    ``LunaBlock``) and a ``FeedForwardBlock`` over an NHWC map
    (``luna.py:147-177``): returns (map, aux, attn1, attn2)."""

    def __init__(self, dim: int, aux_dim: int, qk_proj_dim: int, num_heads: int,
                 pre_norm: bool = False, feedforward_dim: Optional[int] = None,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1,
                 act: Callable[[torch.Tensor], torch.Tensor] = gelu):
        super().__init__()
        # imported here, as JAX does: the models package imports this module
        from ..models.depthformer.layers import FeedForwardBlock
        block = PreNormLunaBlock if pre_norm else LunaBlock
        self.luna_attn = block(dim, aux_dim, qk_proj_dim, num_heads, attn_drop_prob, drop_prob)
        self.feed_forward = FeedForwardBlock(dim, feedforward_dim, drop_prob, act,
                                             post_norm=not pre_norm)

    def forward(self, hidden_nhwc: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Attns:
        b, h, w, d = hidden_nhwc.shape
        hidden, aux, attn1, attn2 = self.luna_attn(hidden_nhwc.reshape(b, h * w, d), aux,
                                                   generator)
        hidden = self.feed_forward(hidden, generator)
        return hidden.reshape(b, h, w, d), aux, attn1, attn2
