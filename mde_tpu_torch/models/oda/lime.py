"""ODA Lime (``mde_tpu/models/oda/lime.py``): a light conv decoder with
global channel cross-attention over an encoder memory.

The four encoder stages are resized nearest to 1/4 and concatenated
(2,880 channels at Swin-L), then an LN and a Dense to 2048 make the
memory, divided by ``num_layers``. A stem of two 4x4 stride-2 convs maps
the image to the 1/4 hidden map; then ``num_layers`` times a residual
1x1-3x3-1x1 ConvBN block and a channel cross-attention over every pixel
(the logits k^T q over channels, (B, d, d), scaled by 1/sqrt(S) over the
S pixels at 1/4, softmaxed in f32 over the first channel index); the
head is two ConvBNs and a 1x1 conv at **1/4** scale.

The model resizes its input to the 384 multiples (``oda_resize_policy``)
and builds its encoder with the resize off: with the resize, every
window is 12; without it, ``img_size`` fixes them at build.

Parameter names follow the reference torch decoder, the names
``mde_tpu.core.family_converters.convert_oda_lime_decoder``
(``:428-471``) converts from: ``stem_conv.{0,1,3,4}`` (slot 2 the GELU),
``stem_enc.{0,1}``, ``layers.{i}.conv.conv{1,2,3}.{0,1}``,
``layers.{i}.attn.{norm,enc_norm,q_proj,k_proj,v_proj,o_proj}``,
``out_conv.{0,1,2}``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import Conv1x1, ConvBN, EdgeConv, ValidConv
from ...ops.drop import Dropout
from ...ops.pad import pad2d
from ...ops.resize import resize_bilinear, resize_nearest
from ...ops.tnn import BatchNorm, LayerNorm, Linear, gelu
from .encoder import oda_resize_policy
from .lion import apply_out_func, channel_attend
from .models import _ODABase

MEMORY_DIM = 2048  # the encoder memory's width, fixed upstream


class LimeConvBlock(nn.Module):
    """Residual 1x1 -> replicate 3x3 -> 1x1 bias-free convs, each with a
    BatchNorm, GELU after the first two (``lime.py:36-62``)."""

    def __init__(self, dim: int, mid_ch: int, bn_momentum: float = 0.1):
        super().__init__()
        bn = dict(momentum=bn_momentum)
        self.conv1 = nn.Sequential(Conv1x1(dim, mid_ch, bias=False), BatchNorm(mid_ch, **bn))
        self.conv2 = nn.Sequential(EdgeConv(mid_ch, mid_ch, 3), BatchNorm(mid_ch, **bn))
        self.conv3 = nn.Sequential(Conv1x1(mid_ch, dim, bias=False), BatchNorm(dim, **bn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(gelu(self.conv2(gelu(self.conv1(x))))) + x


class LimeCrossAttention(nn.Module):
    """Pre-norm residual channel cross-attention of (B, S, dim) pixels over
    the (B, S, enc_dim) memory (``lime.py:65-99``): q from the pixels, k and
    v from the memory, the logits k^T q. Returns (pixels, the f32 (B, dim,
    dim) weights)."""

    def __init__(self, dim: int, enc_dim: int, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.1):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.enc_norm = LayerNorm(enc_dim)
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(enc_dim, dim)
        self.v_proj = Linear(enc_dim, dim)
        self.o_proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def forward(self, hidden: torch.Tensor, enc: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        e = self.enc_norm(enc)
        out, weights = channel_attend(self.k_proj(e), self.q_proj(self.norm(hidden)),
                                      self.v_proj(e), self.attn_drop, generator)
        return self.drop(self.o_proj(out), generator) + hidden, weights


class LimeLayer(nn.Module):
    """A ``LimeConvBlock`` (``conv``), then a ``LimeCrossAttention``
    (``attn``) over the map's pixels."""

    def __init__(self, dim: int, enc_dim: int, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.1, bn_momentum: float = 0.1):
        super().__init__()
        self.conv = LimeConvBlock(dim, dim, bn_momentum)
        self.attn = LimeCrossAttention(dim, enc_dim, attn_drop_prob, drop_prob)

    def forward(self, hidden: torch.Tensor, enc: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = self.conv(hidden)
        b, h, w, d = hidden.shape
        out, weights = self.attn(hidden.reshape(b, h * w, d), enc, generator)
        return out.reshape(b, h, w, d), weights


class ODALimeDecoder(nn.Module):
    """The Lime decoder (``lime.py:102-170``) over the image and the
    encoder's ``enc_dims``: returns (the (B, H/4, W/4, 1) logits in the
    activation dtype, ``num_layers`` f32 weights)."""

    def __init__(self, enc_dims: Sequence[int], channels: int = 256, num_layers: int = 16,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1, bn_momentum: float = 0.1):
        super().__init__()
        c = channels
        bn = dict(momentum=bn_momentum)
        self.num_layers = num_layers
        # 4x4 convs at stride 2, each after a one-pixel zero pad
        self.stem_conv = nn.Sequential(
            ValidConv(3, c // 2, 4, stride=2, bias=False), BatchNorm(c // 2, **bn), nn.Identity(),
            ValidConv(c // 2, c, 4, stride=2, bias=False), BatchNorm(c, **bn))
        self.stem_enc = nn.Sequential(LayerNorm(sum(enc_dims)),
                                      Linear(sum(enc_dims), MEMORY_DIM))
        self.layers = nn.ModuleList(
            LimeLayer(c, MEMORY_DIM, attn_drop_prob, drop_prob, bn_momentum)
            for _ in range(num_layers))
        self.out_conv = nn.Sequential(ConvBN(c, c, 3, bn_momentum=bn_momentum),
                                      ConvBN(c, c, 3, bn_momentum=bn_momentum),
                                      Conv1x1(c, 1, bias=False))

    def forward(self, img: torch.Tensor, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        f4 = features[0]
        b, q4 = f4.shape[0], tuple(f4.shape[1:3])
        enc = torch.cat([f4] + [resize_nearest(f, q4) for f in features[1:]], dim=-1)
        enc = self.stem_enc(enc.reshape(b, -1, enc.shape[-1]))
        # a true division on the device: CUDA multiplies by a host scalar's
        # reciprocal, JAX divides
        enc = enc / torch.full((), self.num_layers, dtype=enc.dtype, device=enc.device)
        conv0, bn0, _, conv1, bn1 = self.stem_conv
        h = gelu(bn0(conv0(pad2d(img.to(f4.dtype), 1, 1, 1, 1, mode="zeros"))))
        h = bn1(conv1(pad2d(h, 1, 1, 1, 1, mode="zeros")))
        h = resize_bilinear(h, q4, align_corners=True)
        attns = []
        for layer in self.layers:
            h, weights = layer(h, enc, generator)
            attns.append(weights)
        return self.out_conv(h), tuple(attns)


class ODALimeModel(_ODABase):
    """``oda_lime`` (``lime.py:173-215``): returns (depth (B, H/4, W/4, 1) in
    f32 at the resized input's quarter scale, the weights). The model
    resizes; its encoder does not."""

    def __init__(self, decoder_channels: int = 256, decoder_layers: int = 16,
                 min_depth: float = 0.001, max_depth: float = 80.0, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.1, out_func: str = "sigmoid", bn_momentum: float = 0.1,
                 resize_to_multiple: bool = True, img_size: Optional[Tuple[int, int]] = None,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, False, None if resize_to_multiple else img_size,
                         use_checkpoint, dtype, encoder_kwargs)
        self.resize_to_multiple = resize_to_multiple
        self.out_func = out_func
        self.decoder = ODALimeDecoder(self.encoder.backbone.num_features, decoder_channels,
                                      decoder_layers, attn_drop_prob, drop_prob, bn_momentum)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.resize_to_multiple:
            x = resize_bilinear(x, oda_resize_policy(x.shape[1], x.shape[2]),
                                align_corners=True)
        out, attns = self.decoder(x, self.encoder(x, generator), generator)
        return apply_out_func(out, self.out_func, self.min_depth, self.max_depth), attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``decoder_channels`` 256, ``decoder_layers`` 16,
        ``attn_drop_prob`` 0, ``drop_prob`` 0.1, ``out_func`` sigmoid unless
        given), and ``img_size``, which fixes the encoder's windows where
        the resize is off."""
        kwargs = dict(decoder_channels=opt.get("decoder_channels", 256),
                      decoder_layers=opt.get("decoder_layers", 16), min_depth=min_depth,
                      max_depth=max_depth, attn_drop_prob=opt.get("attn_drop_prob", 0.0),
                      drop_prob=opt.get("drop_prob", 0.1),
                      out_func=opt.get("out_func", "sigmoid"), img_size=opt.get("img_size"))
        kwargs.update(overrides)
        return cls(**kwargs)
