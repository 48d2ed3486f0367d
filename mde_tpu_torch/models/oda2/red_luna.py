"""ODA2 ``oda2_red_luna_reg``, stacked split-Luna over the reduction neck
(``mde_tpu/models/oda2/red_luna.py``).

The reduction decoders' neck to a 1/4-scale map of ``dec_dim`` channels; a
fixed aux bank (the unscaled base-10000 sinusoidal table) mixed by
``aux_linear1``, gated by the sigmoid of ``enc_to_aux`` of the mean of the
neck's concat before its Linear, ``aux_linear2`` and ``aux_norm``; then
``num_layers`` x [S1: the aux tokens attend to the pixels + a PreNormFF on
the aux tokens; S2: the pixels attend to the aux tokens + a PreNormFF on
the pixels]; then ConvBN and a 3x3 VALID conv (the map loses 2 px),
sigmoid, scaled to the depth range. The Luna attentions are plain
einsums, as in JAX (no kernel); each returns its f32 softmax, and the
model returns all of them, as JAX's does.

Parameter names follow the reference torch state dict, the names
``mde_tpu.core.family_converters.convert_oda2_red_luna_decoder``
(``:697-734``) converts from: ``enc_conv{s}.{j}``, ``dec_linear``,
``dec_norm``, ``aux_linear1``, ``enc_to_aux``, ``aux_linear2``,
``aux_norm``, ``luna.layers.{i}.{luna1,ff_aux,luna2,ff}``,
``out_conv.{0,1}``. The converter skips the reference's ``aux`` buffer
and JAX regenerates the table, so the port keeps it as a non-persistent
buffer, outside the state dict.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import ConvBN, ValidConv
from ...ops.drop import Dropout
from ...ops.mlp import PreNormFF
from ...ops.reduction import attend, sinusoidal_depth_embedding
from ...ops.tnn import LayerNorm, Linear
from .base import SwinDepthModel
from .red_order_reg import RedNeck

Weights = Tuple[torch.Tensor, ...]


class SplitLuna(nn.Module):
    """S1 (``s2`` False: the aux tokens attend to the pixels, residual on
    the aux tokens) or S2 (the pixels attend to the aux tokens, residual on
    the pixels), both pre-norm (``red_luna.py:43-89``): ``norm`` the map,
    ``aux_norm`` the aux tokens, ``q_proj``, ``k_proj``, ``v_proj``, the
    attention at scale (d / heads)^-0.5, ``o_proj``, dropout, residual.
    Returns (the updated map or aux tokens, the f32 softmax)."""

    def __init__(self, dim: int, num_heads: int, s2: bool = False,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"{dim} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.s2 = s2
        self.norm = LayerNorm(dim)
        self.aux_norm = LayerNorm(dim)
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.o_proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, d = x.shape
        xn = self.norm(x).reshape(b, h * w, d)
        an = self.aux_norm(aux)
        q_in, kv_in, identity = (xn, an, x.reshape(b, h * w, d)) if self.s2 else (an, xn, aux)
        out, weights = attend(self.q_proj(q_in), self.k_proj(kv_in), self.v_proj(kv_in),
                              self.num_heads, self.attn_drop, generator)
        out = self.drop(self.o_proj(out), generator) + identity
        return (out.reshape(b, h, w, d) if self.s2 else out), weights


class LunaModule(nn.Module):
    """One layer of the stack: ``luna1`` (S1), ``ff_aux``, ``luna2`` (S2),
    ``ff`` (``red_luna.py:102-114``)."""

    def __init__(self, dim: int, num_heads: int, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.0):
        super().__init__()
        rates = dict(attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)
        self.luna1 = SplitLuna(dim, num_heads, False, **rates)
        self.ff_aux = PreNormFF(dim, drop_prob=drop_prob)
        self.luna2 = SplitLuna(dim, num_heads, True, **rates)
        self.ff = PreNormFF(dim, drop_prob=drop_prob)

    def forward(self, x: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Weights]:
        aux, a1 = self.luna1(x, aux, generator)
        aux = self.ff_aux(aux, generator)
        x, a2 = self.luna2(x, aux, generator)
        return self.ff(x, generator), aux, (a1, a2)


class StackedLunaModule(nn.Module):
    """``num_layers`` Luna layers (``red_luna.py:92-116``); returns (map,
    aux tokens, each layer's two f32 softmaxes in order)."""

    def __init__(self, dim: int, num_heads: int, num_layers: int,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(LunaModule(dim, num_heads, attn_drop_prob, drop_prob)
                                    for _ in range(num_layers))

    def forward(self, x: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Weights]:
        attns: Weights = ()
        for layer in self.layers:
            x, aux, weights = layer(x, aux, generator)
            attns += weights
        return x, aux, attns


class LunaTransformerRegDecoder(RedNeck):
    """Neck, aux bank, stacked split-Luna, ConvBN to d/4 and the 3x3 VALID
    conv to one channel; the f32 sigmoid map in [0, 1]
    (``red_luna.py:119-172``). Returns (map, aux tokens, attention
    weights)."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int, num_aux: int = 256,
                 num_heads: int = 8, num_layers: int = 4, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__(enc_dims, dec_dim, 2, bn_momentum, bn_eps)
        d = dec_dim
        self.register_buffer("aux", sinusoidal_depth_embedding(num_aux, d, 10000.0, False),
                             persistent=False)
        self.aux_linear1 = Linear(d, d)
        self.enc_to_aux = Linear(self.dec_linear.in_features, d)
        self.aux_linear2 = Linear(d, d, bias=False)
        self.aux_norm = LayerNorm(d)
        self.luna = StackedLunaModule(d, num_heads, num_layers, attn_drop_prob, drop_prob)
        self.out_conv = nn.Sequential(
            ConvBN(d, d // 4, 3, bn_eps, bn_momentum=bn_momentum), ValidConv(d // 4, 1, 3))

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Weights]:
        dec, cat = self.neck_concat(features)
        b = dec.shape[0]
        aux = self.aux_linear1(self.aux.to(dec.dtype).expand(b, -1, -1))
        gate = self.enc_to_aux(cat.float().mean(dim=(1, 2)).to(dec.dtype))
        aux = self.aux_norm(self.aux_linear2(aux * torch.sigmoid(gate.to(aux.dtype))[:, None]))
        dec, aux, attns = self.luna(dec, aux, generator)
        return torch.sigmoid(self.out_conv(dec).float()), aux, attns


class ODA2RedLunaRegModel(SwinDepthModel):
    """Swin encoder + stacked split-Luna decoder (``red_luna.py:175-234``).
    ``forward`` takes (B, H, W, 3) f32 images and returns ``(depth,
    attns)``: one f32 map at 1/4 scale less 2 px, ``sigmoid * (max_depth -
    min_depth) + min_depth``, and the 2 * ``num_layers`` f32 attention
    weights, (B, heads, num_aux, HW) for S1 and (B, heads, HW, num_aux) for
    S2. ``dtype``, ``generator`` and ``use_checkpoint`` (the encoder only)
    as ``ODA2OrderedRegModel``'s."""

    def __init__(self, dec_dim: int, min_depth: float, max_depth: float, num_heads: int = 8,
                 num_layers: int = 4, num_aux: int = 256, encoder_type: str = "large",
                 drop_prob: float = 0.0, attn_drop_prob: float = 0.0, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5, use_checkpoint: bool = True, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.decoder = LunaTransformerRegDecoder(
            self.encoder.num_features, dec_dim, num_aux, num_heads, num_layers, attn_drop_prob,
            drop_prob, bn_momentum, bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Weights]:
        out, _, attns = self.decoder(self.features(x, generator), generator)
        return out * (self.max_depth - self.min_depth) + self.min_depth, attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``red_luna.py:221-234``: 8 heads, 4 layers, 256
        aux tokens, no dropout)."""
        kwargs = dict(
            dec_dim=opt["dec_dim"], num_heads=opt.get("num_heads", 8),
            num_layers=opt.get("num_layers", 4), num_aux=opt.get("num_aux", 256),
            min_depth=min_depth, max_depth=max_depth,
            encoder_type=opt.get("encoder_type", "large"),
            drop_prob=opt.get("drop_prob", 0.0), attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
