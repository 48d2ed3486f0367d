"""ODA2 ``oda2_red_order_swin``, the gen-1 ordered windowed refinement
(``mde_tpu/models/oda2/red_order_swin.py``).

Unlike the flagship it has no relative-depth bias: each repeat quantises
the log-sigmoid of its logit (as ``oda2_red_order_reg``), looks the indices
up in a learnable table stored unscaled and multiplied by sqrt(1/d) at the
lookup, and adds the embedding through Linear + LayerNorm at the top of the
block. The block runs plain FFs before plain window SAs (``ff1``, ``sa1``
at shift 0, ``ff2``, ``sa2`` at shift r/2), each SA the ordered SA without
its table: kernel K2's bias-free entry, forward and backward. The neck has
three ConvBNs a scale, in -> in -> d/4 -> d/4.

Parameter names follow the reference torch state dict, the names
``mde_tpu.core.family_converters.convert_oda2_red_order_swin_decoder``
(``:796-841``) converts from: ``enc_conv{s}.{j}``, ``dec_linear``,
``dec_norm``, ``reducer.depth_embedding``, ``reducer.conv_layers.{i}.{j}``,
``reducer.attn_layers.{i}`` with ``de_proj``, ``de_norm``, ``ff1``, ``sa1``
(``norm``, ``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``), ``ff2``,
``sa2``, ``linear``, ``norm``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.mlp import PreNormFF
from ...ops.ordered_attention import PreNormOrderedSwinSA
from ...ops.reduction import sinusoidal_depth_embedding
from ...ops.tnn import LayerNorm, Linear
from .base import SwinDepthModel
from .red_order_reg import Attns, IndexedTableHead, RedNeck


class Gen1OrderedSwinBlock(nn.Module):
    """x + LN(Linear(de)); ff1, sa1 (shift 0), ff2, sa2 (shift r/2); Linear
    and LN (``red_order_swin.py:37-77``). The SAs are bias-free ordered
    window SAs. Returns (x, the two SAs' weights: None)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 feedforward_dims: Optional[int] = None, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.0):
        super().__init__()
        self.de_proj = Linear(dim, dim, bias=False)
        self.de_norm = LayerNorm(dim)
        sa = dict(num_heads=num_heads, num_emb=1, window_size=window_size, bias_type="none",
                  attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)
        self.ff1 = PreNormFF(dim, feedforward_dims, drop_prob)
        self.sa1 = PreNormOrderedSwinSA(dim, shift_size=0, **sa)
        self.ff2 = PreNormFF(dim, feedforward_dims, drop_prob)
        self.sa2 = PreNormOrderedSwinSA(dim, shift_size=window_size // 2, **sa)
        self.linear = Linear(dim, dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, de: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Attns]:
        x = x + self.de_norm(self.de_proj(de))
        x = self.sa1(self.ff1(x, generator), None, generator)
        x = self.sa2(self.ff2(x, generator), None, generator)
        return self.norm(self.linear(x)), (None, None)


class Gen1OrderedSwinHead(IndexedTableHead):
    """Gen-1's head (``red_order_swin.py:121-174``): the unscaled learnable
    base-2000 table, times sqrt(1/d) at lookup, and gen-1's blocks."""

    def __init__(self, in_dims: int, num_heads: int, num_repeats: int, num_emb: int = 128,
                 window_size: int = 8, attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__(
            in_dims, num_repeats, num_emb,
            lambda: Gen1OrderedSwinBlock(in_dims, num_heads, window_size,
                                         attn_drop_prob=attn_drop_prob, drop_prob=drop_prob),
            math.sqrt(1.0 / in_dims), bn_momentum, bn_eps)
        self.depth_embedding = nn.Parameter(
            sinusoidal_depth_embedding(num_emb, in_dims, 2000.0) * math.sqrt(float(in_dims)))


class Gen1OrderedSwinDecoder(RedNeck):
    """The three-conv neck and the gen-1 head (``red_order_swin.py:177-203``)."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int, num_heads: int,
                 num_repeats: int, num_emb: int = 128, window_size: int = 8,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__(enc_dims, dec_dim, 3, bn_momentum, bn_eps)
        self.reducer = Gen1OrderedSwinHead(dec_dim, num_heads, num_repeats, num_emb,
                                           window_size, attn_drop_prob, drop_prob,
                                           bn_momentum, bn_eps)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], Attns]:
        return self.reducer(self.neck(features), generator)


class ODA2OrderedSwinModel(SwinDepthModel):
    """Swin encoder + gen-1 decoder (``red_order_swin.py:206-268``); the
    contract, ``dtype``, ``generator`` and ``use_checkpoint`` (the encoder
    only) are ``ODA2OrderedRegModel``'s."""

    def __init__(self, dec_dim: int, min_depth: float, max_depth: float, num_heads: int,
                 num_repeats: int, num_emb: int, window_size: int = 8,
                 encoder_type: str = "large", drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_checkpoint: bool = True, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.decoder = Gen1OrderedSwinDecoder(
            self.encoder.num_features, dec_dim, num_heads, num_repeats, num_emb, window_size,
            attn_drop_prob, drop_prob, bn_momentum, bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], Attns]:
        outs, attns = self.decoder(self.features(x, generator), generator)
        outs = tuple(o.float() * self.max_depth for o in outs)
        return outs[-1], outs, attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``red_order_swin.py:255-268``)."""
        kwargs = dict(
            dec_dim=opt["dec_dim"], num_heads=opt["num_heads"],
            num_repeats=opt["num_repeats"], num_emb=opt["num_emb"],
            window_size=opt.get("window_size", 8), min_depth=min_depth, max_depth=max_depth,
            encoder_type=opt.get("encoder_type", "large"),
            drop_prob=opt.get("drop_prob", 0.0), attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
