"""ODA2 conv baseline ``oda2_conv`` (``mde_tpu/models/oda2/conv.py``):
Swin encoder, the pyramid pooling module at 1/32, a top-down conv pyramid
to a 1/2-scale map, sigmoid, scaled to the depth range.

Parameter names follow the reference torch state dict, the names
``mde_tpu.core.family_converters.convert_oda2_conv_decoder``
(``:550-570``) converts from: ``ppm``, ``block{32,16,8}.{0,1,3}`` (the 1x1
ConvBN after the parameter-free upsample at index 2), ``block4.{0,1}``,
``block2.{0,1}``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import Conv1x1, ConvBN
from ...ops.ppm import PyramidPoolingModule
from .base import SwinDepthModel, Upsample2d


class ODA2ConvDecoder(nn.Module):
    """PPM (``channels / 2`` a pooled size, ``channels`` out) at 1/32; per
    level ConvBN -> ConvBN -> x2 upsample -> 1x1 ConvBN without activation
    to the next level's width (none at 1/4), each level's input
    concatenated with the encoder's map; ConvBN and a 1x1 conv at 1/2
    (``conv.py:22-56``)."""

    def __init__(self, enc_dims: Sequence[int], channels: int, output_channel: int = 1,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        c = channels
        c4, c8, c16, c32 = enc_dims
        ck = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
        self.ppm = PyramidPoolingModule(c32, c // 2, c, **ck)

        def block(in_ch, mid, nxt=None):
            layers = [ConvBN(in_ch, mid, 3, **ck), ConvBN(mid, mid, 3, **ck), Upsample2d(2)]
            if nxt:
                layers.append(ConvBN(mid, nxt, 1, act=None, **ck))
            return nn.Sequential(*layers)

        self.block32 = block(c, c, c // 2)
        self.block16 = block(c // 2 + c16, c // 2, c // 4)
        self.block8 = block(c // 4 + c8, c // 4, c // 8)
        self.block4 = block(c // 8 + c4, c // 8)
        self.block2 = nn.Sequential(ConvBN(c // 8, c // 8, 3, **ck),
                                    Conv1x1(c // 8, output_channel, bias=True))

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        f4, f8, f16, f32 = features
        x = self.block32(self.ppm(f32))
        x = self.block16(torch.cat([x, f16], dim=-1))
        x = self.block8(torch.cat([x, f8], dim=-1))
        x = self.block4(torch.cat([x, f4], dim=-1))
        return self.block2(x)


class ODA2ConvModel(SwinDepthModel):
    """Swin encoder + conv decoder (``conv.py:61-110``). ``forward`` takes
    (B, H, W, 3) f32 images and returns ``(depth, None)``: one f32 map at
    1/2 scale, ``sigmoid * (max_depth - min_depth) + min_depth``.
    ``dtype``, ``generator`` and ``use_checkpoint`` (the encoder only) as
    ``ODA2OrderedRegModel``'s."""

    def __init__(self, decoder_channels: int, min_depth: float, max_depth: float,
                 encoder_type: str = "large", bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_checkpoint: bool = True, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.decoder = ODA2ConvDecoder(self.encoder.num_features, decoder_channels,
                                       bn_momentum=bn_momentum, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, None]:
        out = torch.sigmoid(self.decoder(self.features(x, generator)).float())
        return out * (self.max_depth - self.min_depth) + self.min_depth, None

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``conv.py:100-110``: ``decoder_channels`` falls
        back to ``dec_dim``, then to 1024)."""
        kwargs = dict(
            decoder_channels=opt.get("decoder_channels", opt.get("dec_dim", 1024)),
            min_depth=min_depth, max_depth=max_depth,
            encoder_type=opt.get("encoder_type", "large"),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
