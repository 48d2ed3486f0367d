"""The ODA decoders (``mde_tpu/models/oda/decoders.py``): the plain conv
decoder and the Luna decoder (bilinear upsampling, or ``use_rp``'s pixel
shuffle after a gen-1 PPM at 1/32).

Top-down over the four Swin-L stages: at each scale [the concat with the
encoder's map ->] 3x3 ConvBN(s) [-> a pre-norm Luna layer sharing one
learned aux token bank] -> x2 upsample -> a 1x1 ConvBN to the next width;
at 1/2 a 3x3 ConvBN and a biased 1x1 head. Widths (c/8, c/4, c/2, c); the
Luna decoder's first is max(c/8, aux_dim) and its heads (max(num_aux/8,
1), heads/4, heads/2, heads), both as JAX keeps them (``:90-92``): 32 heads
of dim 8 at 1/4 scale for 256 aux tokens of 256.

Parameter names follow the reference torch decoders, the names
``mde_tpu.core.family_converters.convert_oda_conv_decoder`` and
``convert_oda_luna_decoder`` (``:283-352``) convert from:
``block{L}.{0,1,3}`` (slot 2 the upsample), ``block4.{0,1}``,
``block2.{0,1}``; ``aux``, ``ppm``, ``block{L}_pre``, ``block{L}_luna``,
``block{L}_post.1`` (slot 0 the upsample).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import Conv1x1, ConvBN
from ...ops.luna import LunaLayer
from ...ops.pixel_shuffle import pixel_shuffle
from ...ops.ppm import PyramidPoolingModuleV1
from ...ops.resize import upsample2d
from ..oda2.base import Upsample2d


class PixelShuffle(nn.Module):
    """Parameter-free x``scale`` pixel shuffle of NHWC input."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.scale)


class ODAConvDecoder(nn.Module):
    """The conv decoder (``decoders.py:32-68``) over the encoder's
    ``enc_dims``: (B, H/2, W/2, ``output_channel``) in the activation
    dtype. ``use_gn`` takes GroupNorms of ``num_groups`` for the
    BatchNorms."""

    def __init__(self, enc_dims: Sequence[int], channels: int, output_channel: int = 1,
                 use_gn: bool = False, num_groups: int = 1):
        super().__init__()
        c = channels
        oc = [c // 8, c // 4, c // 2, c]
        c4, c8, c16, c32 = enc_dims
        ck = dict(use_gn=use_gn, gn_groups=num_groups)

        def block(cin, mid, nxt=None):
            layers = [ConvBN(cin, mid, 3, **ck), ConvBN(mid, mid, 3, **ck), Upsample2d(2)]
            if nxt is not None:
                layers.append(ConvBN(mid, nxt, 1, act=None, **ck))
            return nn.Sequential(*layers)

        self.block32 = block(c32, oc[3], oc[2])
        self.block16 = block(oc[2] + c16, oc[2], oc[1])
        self.block8 = block(oc[1] + c8, oc[1], oc[0])
        self.block4 = block(oc[0] + c4, oc[0])
        self.block2 = nn.Sequential(ConvBN(oc[0], oc[0], 3, **ck),
                                    Conv1x1(oc[0], output_channel, bias=True))

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        f4, f8, f16, f32 = features
        x = self.block32(f32)
        x = self.block16(torch.cat([x, f16], dim=-1))
        x = self.block8(torch.cat([x, f8], dim=-1))
        x = self.block4(torch.cat([x, f4], dim=-1))
        return self.block2(x)


class ODALunaDecoder(nn.Module):
    """The Luna decoder (``decoders.py:71-139``) over the encoder's
    ``enc_dims``: returns (the (B, H/2, W/2, ``output_channel``) map in the
    activation dtype, the (B, num_aux, aux_dim) aux tokens, the eight f32
    Luna weights (attn1, attn2) at 1/4, 1/8, 1/16 and 1/32). The aux bank
    is drawn N(0, 1/aux_dim)."""

    def __init__(self, enc_dims: Sequence[int], channels: int, num_aux: int, aux_dim: int,
                 num_heads: int, attn_drop_prob: float = 0.0, drop_prob: float = 0.1,
                 output_channel: int = 1, use_gn: bool = False, num_groups: int = 1,
                 use_rp: bool = False):
        super().__init__()
        c = channels
        oc = [max(c // 8, aux_dim), c // 4, c // 2, c]
        heads = [max(num_aux // 8, 1), num_heads // 4, num_heads // 2, num_heads]
        c4, c8, c16, c32 = enc_dims
        ck = dict(use_gn=use_gn, gn_groups=num_groups)
        self.aux_dim = aux_dim
        self.use_rp = use_rp
        self.aux = nn.Parameter(torch.zeros(1, num_aux, aux_dim))
        if use_rp:
            self.ppm = PyramidPoolingModuleV1(c32, c32)
        shrink = 4 if use_rp else 1  # channels a pixel shuffle leaves
        up = PixelShuffle if use_rp else Upsample2d
        ins = {32: c32, 16: oc[2] + c16, 8: oc[1] + c8, 4: oc[0] + c4}
        for level, mid, nxt, nh in ((32, oc[3], oc[2], heads[3]), (16, oc[2], oc[1], heads[2]),
                                    (8, oc[1], oc[0], heads[1]), (4, oc[0], None, heads[0])):
            setattr(self, f"block{level}_pre", ConvBN(ins[level], mid, 3, **ck))
            setattr(self, f"block{level}_luna",
                    LunaLayer(mid, aux_dim, min(mid, aux_dim), nh, pre_norm=True,
                              attn_drop_prob=attn_drop_prob, drop_prob=drop_prob))
            if nxt is not None:
                setattr(self, f"block{level}_post",
                        nn.Sequential(up(2), ConvBN(mid // shrink, nxt, 1, act=None, **ck)))
        self.block2 = nn.Sequential(ConvBN(oc[0] // shrink, oc[0], 3, **ck),
                                    Conv1x1(oc[0], output_channel, bias=True))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        self.aux.data.normal_(0.0, math.sqrt(1.0 / self.aux_dim), generator=generator)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        f4, f8, f16, f32 = features
        aux = self.aux.expand(f4.shape[0], -1, -1).to(f4.dtype)
        x = self.ppm(f32) if self.use_rp else f32
        attns: Tuple[torch.Tensor, ...] = ()
        for level, skip in ((32, None), (16, f16), (8, f8), (4, f4)):
            if skip is not None:
                x = torch.cat([x, skip], dim=-1)
            x = getattr(self, f"block{level}_pre")(x)
            x, aux, a1, a2 = getattr(self, f"block{level}_luna")(x, aux, generator)
            attns = (a1, a2) + attns
            post = getattr(self, f"block{level}_post", None)
            if post is not None:
                x = post(x)
            else:
                x = pixel_shuffle(x, 2) if self.use_rp else upsample2d(x, 2)
        return self.block2(x), aux, attns
