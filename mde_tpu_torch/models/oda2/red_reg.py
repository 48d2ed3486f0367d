"""ODA2 ``oda2_red_reg``, the incremental reduction transformer
(``mde_tpu/models/oda2/red_reg.py``): the reduction decoders' neck to a
1/4-scale map, then 4 x (reduction SA + FF) at reduction ratios 8, 8, 4, 4
and shifts 0, 4, 0, 2, then ConvBN and a 3x3 VALID conv (the reference's
padding 0: the map loses 2 px), sigmoid, scaled to the depth range.

Parameter names follow the reference torch state dict, the names
``mde_tpu.core.family_converters.convert_oda2_red_decoder`` (``:617-636``)
converts from: ``enc_conv{s}.{j}``, ``dec_linear``, ``dec_norm``,
``reducer.sa{r}_{i}``, ``reducer.ff{r}_{i}``, ``out_conv.0``,
``out_conv.1``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import ConvBN, ValidConv
from ...ops.mlp import PreNormFF
from ...ops.reduction import PreNormReductionSA
from .base import SwinDepthModel
from .red_order_reg import Attns, RedNeck

# (name, reduction ratio, shift) of each SA + FF pair, in order
STAGES = (("8_1", 8, 0), ("8_2", 8, 4), ("4_1", 4, 0), ("4_2", 4, 2))


class IncrementalReductionModule(nn.Module):
    """``sa8_1``, ``ff8_1`` ... ``sa4_2``, ``ff4_2`` (``red_reg.py:26-47``).
    Returns (x, four None weights)."""

    def __init__(self, dim: int, num_heads: int, feedforward_dims: Optional[int] = None,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        for name, ratio, shift in STAGES:
            setattr(self, f"sa{name}", PreNormReductionSA(dim, num_heads, ratio, shift,
                                                          attn_drop_prob, drop_prob))
            setattr(self, f"ff{name}", PreNormFF(dim, feedforward_dims, drop_prob))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Attns]:
        for name, _, _ in STAGES:
            x = getattr(self, f"sa{name}")(x, generator)
            x = getattr(self, f"ff{name}")(x, generator)
        return x, (None,) * len(STAGES)


class ReductionTransformerRegDecoder(RedNeck):
    """Neck, reducer, ConvBN to d/4 and the 3x3 VALID conv to one channel;
    the f32 sigmoid map in [0, 1] (``red_reg.py:50-81``)."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int, num_heads: int = 16,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__(enc_dims, dec_dim, 2, bn_momentum, bn_eps)
        self.reducer = IncrementalReductionModule(dec_dim, num_heads,
                                                  attn_drop_prob=attn_drop_prob,
                                                  drop_prob=drop_prob)
        self.out_conv = nn.Sequential(
            ConvBN(dec_dim, dec_dim // 4, 3, bn_eps, bn_momentum=bn_momentum),
            ValidConv(dec_dim // 4, 1, 3))

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Attns]:
        x, attns = self.reducer(self.neck(features), generator)
        return torch.sigmoid(self.out_conv(x).float()), attns


class ODA2RedRegModel(SwinDepthModel):
    """Swin encoder + incremental reduction decoder (``red_reg.py:84-138``).
    ``forward`` takes (B, H, W, 3) f32 images and returns ``(depth,
    attns)``: one f32 map at 1/4 scale less 2 px, ``sigmoid * (max_depth -
    min_depth) + min_depth``, and four None weights. ``dtype``,
    ``generator`` and ``use_checkpoint`` (the encoder only) as
    ``ODA2OrderedRegModel``'s."""

    def __init__(self, dec_dim: int, min_depth: float, max_depth: float, num_heads: int = 16,
                 encoder_type: str = "large", drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_checkpoint: bool = True, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.decoder = ReductionTransformerRegDecoder(
            self.encoder.num_features, dec_dim, num_heads, attn_drop_prob, drop_prob,
            bn_momentum, bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Attns]:
        out, attns = self.decoder(self.features(x, generator), generator)
        return out * (self.max_depth - self.min_depth) + self.min_depth, attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``red_reg.py:127-138``: 16 heads)."""
        kwargs = dict(
            dec_dim=opt["dec_dim"], num_heads=opt.get("num_heads", 16),
            min_depth=min_depth, max_depth=max_depth,
            encoder_type=opt.get("encoder_type", "large"),
            drop_prob=opt.get("drop_prob", 0.0), attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
