"""Plain ``oda_conv``: Swin-L/384 with 12x12 windows behind an
align-corners resize of each side to the nearest multiple of 384, and a
top-down conv decoder over its four stage outputs (no output norms).

The encoder drops with rate 0.1 (after the patch embedding, after each
attention's projection and after both MLP layers) and stochastic depth
rising to 0.1. The decoder, at widths (c/8, c/4, c/2, c) for
``decoder_channels`` c, runs two 3x3 ConvBNs at each scale [after the
concatenation with the encoder's map], a 2x upsample and a 1x1 ConvBN
without activation to the next width; at 1/2 a 3x3 ConvBN and a biased
1x1 conv to one channel, whose sigmoid spans [min_depth, max_depth].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Conv, ConvBN, Numerics, Upsample, resize
from .swin import SwinEncoder


def resize_policy(h: int, w: int) -> Tuple[int, int]:
    return (max(384, round(h / 384) * 384), max(384, round(w / 384) * 384))


class ODAConv(nn.Module):
    """``model``: the configuration's model section (``decoder_channels``,
    and ``encoder_kwargs`` to override the encoder's sizes and rates);
    ``input_hw``: the size of the images it is called on."""

    def __init__(self, num: Numerics, model: dict, min_depth: float, max_depth: float,
                 input_hw: Tuple[int, int], checkpoint_blocks: bool = True):
        super().__init__()
        self.num, self.min_depth, self.max_depth = num, min_depth, max_depth
        ek = dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                  window_size=12, drop_prob=0.1, path_drop_prob=0.1)
        ek.update(model.get("encoder_kwargs") or {})
        self.hw = resize_policy(*input_hw)
        self.encoder = nn.Module()
        self.encoder.backbone = SwinEncoder(
            num, ek["embed_dim"], ek["depths"], ek["num_heads"], ek["window_size"],
            ek["path_drop_prob"], ek["drop_prob"], self.hw, True, False, checkpoint_blocks)
        dims = [ek["embed_dim"] * 2 ** i for i in range(4)]
        c = model["decoder_channels"]
        oc = [c // 8, c // 4, c // 2, c]

        def block(cin, mid, nxt=None):
            layers = [ConvBN(num, cin, mid, 3), ConvBN(num, mid, mid, 3), Upsample(2)]
            if nxt is not None:
                layers.append(ConvBN(num, mid, nxt, 1, act=False))
            return nn.Sequential(*layers)

        self.decoder = nn.Module()
        self.decoder.block32 = block(dims[3], oc[3], oc[2])
        self.decoder.block16 = block(oc[2] + dims[2], oc[2], oc[1])
        self.decoder.block8 = block(oc[1] + dims[1], oc[1], oc[0])
        self.decoder.block4 = block(oc[0] + dims[0], oc[0])
        self.decoder.block2 = nn.Sequential(ConvBN(num, oc[0], oc[0], 3),
                                            Conv(num, oc[0], 1, 1, bias=True))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = resize(x, self.hw).to(self.num.act_dtype)
        f4, f8, f16, f32 = self.encoder.backbone(x, generator)
        d = self.decoder
        y = d.block32(f32)
        y = d.block16(torch.cat([y, f16], dim=-1))
        y = d.block8(torch.cat([y, f8], dim=-1))
        y = d.block2(d.block4(torch.cat([y, f4], dim=-1)))
        depth = torch.sigmoid(y.float()) * (self.max_depth - self.min_depth) + self.min_depth
        return depth, None


def build(config: dict, num: Numerics, input_hw: Tuple[int, int],
          checkpoint_blocks: bool) -> ODAConv:
    return ODAConv(num, config["model"], config["min_depth"], config["max_depth"], input_hw,
                   checkpoint_blocks)
