"""Plain ``oda2_red_order_swin2``: a Swin encoder with output norms, the
red33 neck and the ordered-depth refinement head.

The input is resized (align corners) to the flagship's sizes: KITTI
352x704 -> 448x896, 352x1216 -> 448x1536, NYU 480x640 and 448x608 ->
448x672, other sizes up to multiples of 224. Each of ``num_repeats``
rounds runs a conv head to a one-channel logit, whose sigmoid is one
output map, and quantises the sigmoid into ``num_emb`` indices
(floor(p * E - 1e-3), clamped to [0, E)); an ordered block then attends
within 8x8 windows (the second attention shifted by 4, with no region
mask), the logits biased by ``depth_embedding[i_q - i_k + E - 1]``, each
attention followed by a GLU feed-forward with a replicate-padded 5x5
depthwise convolution and BatchNorm. Every map is scaled by
``max_depth``; the last is the prediction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (BatchNorm, Conv, ConvBN, LayerNorm, Linear, Numerics, attend, conv2d,
                     gelu, shift, unshift, unwindows, upsample, windows, resize)
from .swin import SwinEncoder

SWIN = {"base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
        "large": (192, (2, 2, 18, 2), (6, 12, 24, 48))}


def resize_policy(h: int, w: int, max_depth: float) -> Tuple[int, int]:
    known = {(352, 704): (448, 896), (352, 1216): (448, 1536),
             (480, 640): (448, 672), (448, 608): (448, 672)}
    if (h, w) in known:
        return known[(h, w)]
    if max_depth > 40:
        return (max(224, -(-h // 224) * 224), max(224, -(-w // 224) * 224))
    return (max(224, round(h / 224) * 224), max(224, round(w / 224) * 224))


class OrderedSA(nn.Module):
    def __init__(self, num: Numerics, dim: int, heads: int, num_emb: int, window: int,
                 shift_size: int):
        super().__init__()
        self.num, self.heads, self.num_emb = num, heads, num_emb
        self.window, self.shift_size = window, shift_size
        self.norm = LayerNorm(num, dim)
        self.q_proj, self.k_proj = Linear(num, dim, dim), Linear(num, dim, dim)
        self.v_proj, self.o_proj = Linear(num, dim, dim), Linear(num, dim, dim)
        self.depth_embedding = nn.Parameter(torch.zeros(2 * num_emb - 1, heads))

    def forward(self, x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        r, s = self.window, self.shift_size
        xn = self.norm(windows(shift(x, s), r))
        idx = windows(shift(indices[..., None], s), r)[..., 0].long()
        rel = idx[:, :, None] - idx[:, None, :] + (self.num_emb - 1)
        add = self.depth_embedding[rel].permute(0, 3, 1, 2).float()
        out = attend(self.num, self.q_proj(xn), self.k_proj(xn), self.v_proj(xn), self.heads,
                     (c // self.heads) ** -0.5, add)
        return unshift(unwindows(self.o_proj(out), r, h, w), s) + x


class DWConvFF(nn.Module):
    def __init__(self, num: Numerics, dim: int, kernel: int = 5, momentum: float = 0.1):
        super().__init__()
        hidden = 4 * dim
        self.num = num
        self.norm = LayerNorm(num, dim)
        self.lin1 = Linear(num, dim, 2 * hidden)
        self.conv2 = Conv(num, hidden, hidden, kernel, groups=hidden)
        self.bn2 = BatchNorm(num, hidden, momentum=momentum)
        self.lin3 = Linear(num, hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.lin1(self.norm(x)).chunk(2, dim=-1)
        y = gelu(self.bn2(self.conv2(a * torch.sigmoid(b))))
        return self.lin3(y) + x


class OrderedBlock(nn.Module):
    def __init__(self, num: Numerics, dim: int, heads: int, num_emb: int, window: int):
        super().__init__()
        self.sa1 = OrderedSA(num, dim, heads, num_emb, window, 0)
        self.ff1 = DWConvFF(num, dim)
        self.sa2 = OrderedSA(num, dim, heads, num_emb, window, window // 2)
        self.ff2 = DWConvFF(num, dim)
        self.linear = Linear(num, dim, dim, bias=False)
        self.norm = LayerNorm(num, dim)

    def forward(self, x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        x = self.ff1(self.sa1(x, indices))
        x = self.ff2(self.sa2(x, indices))
        return self.norm(self.linear(x))


def conv_head(num: Numerics, c: int) -> nn.Sequential:
    last = nn.Module()
    last.weight = nn.Parameter(torch.zeros(1, c // 4, 1, 1))
    return nn.Sequential(ConvBN(num, c, c // 4, 3), ConvBN(num, c // 4, c // 4, 3), last)


class Reducer(nn.Module):
    def __init__(self, num: Numerics, c: int, heads: int, repeats: int, num_emb: int,
                 window: int, checkpoint_blocks: bool):
        super().__init__()
        self.num, self.num_emb = num, num_emb
        self.checkpoint_blocks = checkpoint_blocks
        self.conv_layers = nn.ModuleList(conv_head(num, c) for _ in range(repeats + 1))
        self.attn_layers = nn.ModuleList(OrderedBlock(num, c, heads, num_emb, window)
                                         for _ in range(repeats))

    def logit(self, i: int, x: torch.Tensor) -> torch.Tensor:
        head = self.conv_layers[i]
        return conv2d(self.num, head[1](head[0](x)), head[2].weight)

    def forward(self, x: torch.Tensor):
        outs = []
        for i, block in enumerate(self.attn_layers):
            logit = self.logit(i, x)
            outs.append(torch.sigmoid(logit))
            p = torch.sigmoid(logit.detach().float())
            idx = torch.floor(p * self.num_emb - 1e-3).clamp(0, self.num_emb - 1)[..., 0]
            if self.checkpoint_blocks and torch.is_grad_enabled():
                x = checkpoint(block, x, idx, use_reentrant=False)
            else:
                x = block(x, idx)
        outs.append(torch.sigmoid(self.logit(len(self.attn_layers), x)))
        return outs


class Decoder(nn.Module):
    """The red33 neck (two 3x3 ConvBNs to ``dec_dim`` at each scale, each
    upsampled to 1/4, a 1x1 ConvBN over their concatenation), a Linear
    and a LayerNorm, then the head."""

    def __init__(self, num: Numerics, enc_dims, d: int, heads: int, repeats: int,
                 num_emb: int, window: int, checkpoint_blocks: bool):
        super().__init__()
        for s, c in zip(("4", "8", "16", "32"), enc_dims):
            setattr(self, f"enc_conv{s}", nn.Sequential(ConvBN(num, c, d, 3),
                                                        ConvBN(num, d, d, 3)))
        self.enc_fuse = ConvBN(num, 4 * d, d, 1)
        self.dec_linear = Linear(num, d, d, bias=False)
        self.dec_norm = LayerNorm(num, d)
        self.reducer = Reducer(num, d, heads, repeats, num_emb, window, checkpoint_blocks)

    def forward(self, feats):
        ys = [upsample(getattr(self, f"enc_conv{s}")(f), k)
              for s, f, k in zip(("4", "8", "16", "32"), feats, (1, 2, 4, 8))]
        dec = self.enc_fuse(torch.cat(ys, dim=-1))
        return self.reducer(self.dec_norm(self.dec_linear(dec)))


class Flagship(nn.Module):
    """``model``: the configuration's model section (Swin ``base`` or
    ``large``, or ``custom`` with ``encoder_kwargs``); ``input_hw``: the
    size of the images it is called on."""

    def __init__(self, num: Numerics, model: dict, max_depth: float,
                 input_hw: Tuple[int, int], checkpoint_blocks: bool = True,
                 path_drop_prob: float = 0.2):
        super().__init__()
        if model.get("neck_type") != "red33":
            raise ValueError("the reference holds the red33 neck only")
        self.num, self.max_depth = num, max_depth
        ek = dict(model.get("encoder_kwargs") or {})
        embed, depths, heads = SWIN.get(model["encoder_type"], (None, None, None))
        embed = ek.get("embed_dim", embed)
        depths, heads = ek.get("depths", depths), ek.get("num_heads", heads)
        self.hw = resize_policy(*input_hw, max_depth)
        self.encoder = SwinEncoder(num, embed, depths, heads, 7, path_drop_prob, 0.0, self.hw,
                                   False, True, checkpoint_blocks)
        self.decoder = Decoder(num, [embed * 2 ** i for i in range(4)], model["dec_dim"],
                               model["num_heads"], model["num_repeats"], model["num_emb"],
                               model.get("window_size", 8), checkpoint_blocks)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = resize(x, self.hw).to(self.num.act_dtype)
        outs = [o.float() * self.max_depth
                for o in self.decoder(self.encoder(x, generator))]
        return outs[-1], outs


def build(config: dict, num: Numerics, input_hw: Tuple[int, int],
          checkpoint_blocks: bool) -> Flagship:
    model = config["model"]
    return Flagship(num, model, config["max_depth"], input_hw, checkpoint_blocks,
                    model.get("path_drop_prob", 0.2))
