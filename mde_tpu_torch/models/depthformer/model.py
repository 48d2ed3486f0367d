"""Depthformer v1 (``depthformer``): EfficientNet-B5 without its head and a
multi-scale patchify-ViT decoder (``mde_tpu/models/depthformer/model.py``).

Taps 4, 5, 6, 8 and 10 (strides 2 to 32). Top-down, each scale gets a
ConvBNBlock (kernels 9/7/5/3/1 from 1/2 to 1/32), is patchified to the
1/32 token grid, gets the one position embedding that every scale shares,
runs a pre-norm ViT layer and a BatchNorm, and is upsampled (align corners)
and concatenated into the next finer scale. A sigmoid head at 1/2 scale,
in f32, rescaled to (min_depth, max_depth).

The JAX package has no converter for v1: its upstream decoder no longer
constructs (``docs/PARITY.md:133``). Parameter names follow the pattern of
the v2 decoder's (``convert_depthformer_v2_decoder``): ``encoder.original_model.*``,
``decoder.position_embedding``, ``decoder.post_conv_layers.{i}``,
``decoder.patchify_layers.{i}``, ``decoder.vit_layers.{i}``,
``decoder.vit_bn_layers.{i}``, ``decoder.final_block.{0,1,2}``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import Conv1x1, ValidConv
from ...ops.init import xavier_normal_
from ...ops.tnn import BatchNorm, gelu
from ..efficientnet import EfficientNetEncoder
from .layers import ConvBN, ConvBNBlock, ViTLayer, upscale_concat_act

TAPS = (4, 5, 6, 8, 10)  # strides 2, 4, 8, 16, 32


class EfficientNetDepthModel(nn.Module):
    """The frame of the Depthformer models: the B5 encoder (with or without
    ``conv_head``; ``encoder_kwargs`` override its multipliers), the input
    cast to ``dtype``, and the rescale of a sigmoid map to the depth range."""

    def __init__(self, min_depth: float, max_depth: float, with_head: bool,
                 dtype: torch.dtype, encoder_kwargs: Optional[dict]):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.dtype = dtype
        self.encoder = EfficientNetEncoder(**dict(dict(with_head=with_head),
                                                  **(encoder_kwargs or {})))

    def features(self, x: torch.Tensor, taps: Sequence[int] = TAPS) -> Tuple[torch.Tensor, ...]:
        feats = self.encoder(x.to(self.dtype))
        return tuple(feats[i] for i in taps)

    def rescale(self, out: torch.Tensor) -> torch.Tensor:
        return (self.max_depth - self.min_depth) * out + self.min_depth


class DepthFormerDecoder(nn.Module):
    """The v1 decoder (``model.py:26-100``) over the five taps' maps of
    ``enc_channels``; returns (the f32 sigmoid map at 1/2 scale, the
    ViT layers' weights from the finest scale to the coarsest)."""

    def __init__(self, enc_channels: Sequence[int], hidden_dim: int, num_heads: int,
                 img_size: Tuple[int, int], num_repeat: int = 1, attn_drop_prob: float = 0.1,
                 drop_prob: float = 0.1):
        super().__init__()
        d = hidden_dim
        c0, c1, c2, c3, c4 = enc_channels
        n_tokens = (img_size[0] // 32) * (img_size[1] // 32)
        self.position_embedding = nn.Parameter(torch.zeros(n_tokens, d))
        # kernel 9/7/5/3/1 for scales 0..4
        self.post_conv_layers = nn.ModuleList(
            ConvBNBlock(c + (d if i < 4 else 0), d, 2 * (5 - i) - 1)
            for i, c in enumerate((c0, c1, c2, c3, c4)))
        # scale i + 1's map patchified to the 1/32 grid
        self.patchify_layers = nn.ModuleList(ValidConv(d, d, 2 ** (3 - i), stride=2 ** (3 - i))
                                             for i in range(4))
        self.vit_layers = nn.ModuleList(
            ViTLayer(d, num_heads=num_heads, num_repeat=num_repeat,
                     attn_drop_prob=attn_drop_prob, drop_prob=drop_prob) for _ in range(4))
        self.vit_bn_layers = nn.ModuleList(BatchNorm(d) for _ in range(4))
        self.final_block = nn.Sequential(ConvBN(d, d // 2, 3, act=gelu),
                                         ConvBN(d // 2, d // 4, 3, act=gelu),
                                         Conv1x1(d // 4, 1, bias=True))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        xavier_normal_(self.position_embedding.data, generator)

    def _vit(self, i: int, x: torch.Tensor, generator) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.patchify_layers[i](x)
        b, h, w, d = x.shape
        if h * w != self.position_embedding.shape[0]:
            raise ValueError(f"a {h}x{w} token grid against {self.position_embedding.shape[0]} "
                             f"position embeddings")
        t = x.reshape(b, h * w, d) + self.position_embedding.to(x.dtype)
        t, attn = self.vit_layers[i](t, generator)
        return self.vit_bn_layers[i](t.reshape(b, h, w, d)), attn

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        x0, x1, x2, x3, x4 = features
        feat, attn4 = self._vit(3, self.post_conv_layers[4](x4), generator)
        attns = [attn4]
        for i, skip in ((2, x3), (1, x2), (0, x1)):
            c = self.post_conv_layers[i + 1](upscale_concat_act(skip, feat, 2 ** (3 - i)))
            feat, attn = self._vit(i, c, generator)
            attns.insert(0, attn)
        c0 = self.post_conv_layers[0](upscale_concat_act(x0, feat, 16))
        return torch.sigmoid(self.final_block(c0).float()), tuple(attns)


class Depthformer(EfficientNetDepthModel):
    """``forward`` takes (B, H, W, 3) f32 images of exactly ``img_size`` and
    returns ``(depth, (attn1, attn2, attn3, attn4))``: the f32 (B, H/2, W/2,
    1) depth and the (B, heads, N, N) f32 attention weights of the four ViT
    layers over the N = (H/32)(W/32) tokens (``model.py:103-150``).
    ``dtype`` is the activations'."""

    def __init__(self, hidden_dim: int, num_heads: int, img_size: Tuple[int, int],
                 min_depth: float = 0.001, max_depth: float = 80.0, num_repeat: int = 1,
                 attn_drop_prob: float = 0.1, drop_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, False, dtype, encoder_kwargs)
        self.img_size = tuple(img_size)
        self.decoder = DepthFormerDecoder(
            [self.encoder.channels[i] for i in TAPS], hidden_dim, num_heads, self.img_size,
            num_repeat, attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        if tuple(x.shape[1:3]) != self.img_size:
            raise ValueError(f"Depthformer requires input size {self.img_size}, "
                             f"got {tuple(x.shape[1:3])}")
        out, attn = self.decoder(self.features(x), generator)
        return self.rescale(out), attn

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section as the JAX build does
        (``hidden_dim``, ``num_heads``, ``img_size``; ``num_repeat`` 1,
        dropout 0.1 and 0.1 unless given)."""
        kwargs = dict(hidden_dim=opt["hidden_dim"], num_heads=opt["num_heads"],
                      img_size=tuple(opt["img_size"]), min_depth=min_depth,
                      max_depth=max_depth, num_repeat=opt.get("num_repeat", 1),
                      attn_drop_prob=opt.get("attn_drop_prob", 0.1),
                      drop_prob=opt.get("drop_prob", 0.1))
        kwargs.update(overrides)
        return cls(**kwargs)
