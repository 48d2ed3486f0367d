"""ODA Jeju (``mde_tpu/models/oda/jeju.py``): a Luna-style decoder whose aux
tokens attend over [hidden || encoder] and double at each scale.

At each scale from 1/32 to 1/4: a ``JejuBlock`` (attn1: the aux tokens
over the concatenated hidden and encoder pixels; attn2: the pixels over
the updated aux tokens, then dropout and an LN of the residual; both
``ops/reduction.attend`` with the scale (aux_dim / heads)^-0.5), a
``JejuFeedForward`` (1x1 -> grouped replicate 5x5 with as many groups as
the scale's heads -> squeeze-excite to a sixteenth -> 1x1 + BatchNorm,
residual), then ``SpatialUpsample2d`` (bilinear x2, replicate 3x3 conv
to d/2, an LN, or at 1/4 a BatchNorm and GELU) and ``ReorderUpsample1d``
(the aux tokens (B, S, d) read as (B, 2S, d/2), a Dense and an LN). Each
encoder stage gets an LN (``norm_f{i}``), the PPM-v2 output one
(``norm_ppm``); the aux bank (1, num_aux, c) is broadcast, dropped per
image and scaled by sqrt(1/c). Heads are (heads/8, heads/4, heads/2,
heads) from 1/4 upward, at least 1.

The attentions are plain einsums in JAX, so they are here; the grouped
5x5 conv is ``nn.Conv(feature_group_count=)`` there and
``F.conv2d(groups=)`` (cuDNN) here: no port kernel lies on the decoder.

Parameter names follow the reference torch decoder, the names
``mde_tpu.core.family_converters.convert_oda_jeju_decoder``
(``:487-531``) converts from: ``aux``, ``norm_f{i}``, ``ppm``,
``norm_ppm``, ``jeju{L}.jeju_attn.{q,k,v,o}{1,2}_proj``,
``jeju{L}.jeju_attn.norm``,
``jeju{L}.jeju_ff.{conv1.{0,1},conv2.{0,1},se.{0,2},conv3.{0,1}}``,
``hidden_{L}to{L/2}.{conv,norm}`` (at 1/4 ``norm.0``, a BatchNorm),
``aux_{L}to{L/2}.{fc,norm}``, ``out_conv.{0,1,2}``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.conv import Conv1x1, ConvBN, EdgeConv
from ...ops.drop import Dropout
from ...ops.init import trunc_normal_
from ...ops.ppm import PyramidPoolingModuleV2
from ...ops.reduction import attend
from ...ops.resize import upsample2d
from ...ops.tnn import BatchNorm, LayerNorm, Linear, gelu
from .lion import ConvSEBody, apply_out_func
from .models import _ODABase


class JejuBlock(nn.Module):
    """attn1: (B, K, aux_dim) aux tokens over (B, S, dim + enc_dim)
    [hidden || enc], no dropout on its output; attn2: the (B, S, dim)
    pixels over the updated aux tokens, dropout, LN of the residual
    (``jeju.py:41-89``). Returns (pixels, aux, attn1, attn2)."""

    def __init__(self, dim: int, enc_dim: int, aux_dim: int, num_heads: int,
                 qk_proj_dim: Optional[int] = None, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.1):
        super().__init__()
        qk = qk_proj_dim or aux_dim
        if qk % num_heads or aux_dim % num_heads or dim % num_heads:
            raise ValueError(f"{qk}, {aux_dim} and {dim} channels do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.scale = (qk // num_heads) ** -0.5
        self.q1_proj = Linear(aux_dim, qk)
        self.k1_proj = Linear(dim + enc_dim, qk)
        self.v1_proj = Linear(dim + enc_dim, aux_dim)
        self.o1_proj = Linear(aux_dim, aux_dim)
        self.q2_proj = Linear(dim, qk)
        self.k2_proj = Linear(aux_dim, qk)
        self.v2_proj = Linear(aux_dim, dim)
        self.o2_proj = Linear(dim, dim)
        self.norm = LayerNorm(dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def forward(self, hidden: torch.Tensor, enc: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        he = torch.cat([hidden, enc], dim=-1)
        out1, attn1 = attend(self.q1_proj(aux), self.k1_proj(he), self.v1_proj(he),
                             self.num_heads, self.attn_drop, generator, self.scale)
        aux = aux + self.o1_proj(out1)
        out2, attn2 = attend(self.q2_proj(hidden), self.k2_proj(aux), self.v2_proj(aux),
                             self.num_heads, self.attn_drop, generator, self.scale)
        out2 = self.drop(self.o2_proj(out2), generator)
        return self.norm(hidden + out2), aux, attn1, attn2


class JejuFeedForward(ConvSEBody):
    """Residual conv FF (``jeju.py:92-132``): the body at FF width
    ``feedforward_dim`` (default 4 d), its 5x5 conv in ``num_groups``
    groups, squeeze-excite to max(ff / 16, 1), a bias-free 1x1 ``conv3``
    and BatchNorm (momentum 0.1, as JAX fixes it)."""

    def __init__(self, dim: int, num_groups: int = 1, feedforward_dim: Optional[int] = None):
        ff = feedforward_dim or 4 * dim
        super().__init__(dim, ff, max(ff // 16, 1), groups=num_groups)
        self.conv3 = nn.Sequential(Conv1x1(ff, dim, bias=False), BatchNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(self.body(x)) + x


class JejuLayer(nn.Module):
    """One scale's ``JejuBlock`` (``jeju_attn``) over the map's pixels and the
    encoder stage's, then ``JejuFeedForward`` (``jeju_ff``) on the map.
    Returns (map, aux, attn1, attn2)."""

    def __init__(self, dim: int, enc_dim: int, num_heads: int, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.1):
        super().__init__()
        self.jeju_attn = JejuBlock(dim, enc_dim, dim, num_heads, attn_drop_prob=attn_drop_prob,
                                   drop_prob=drop_prob)
        self.jeju_ff = JejuFeedForward(dim, num_heads)

    def forward(self, hidden: torch.Tensor, enc: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        b, h, w, d = hidden.shape
        tokens, aux, attn1, attn2 = self.jeju_attn(
            hidden.reshape(b, h * w, d), enc.reshape(b, h * w, enc.shape[-1]), aux, generator)
        return self.jeju_ff(tokens.reshape(b, h, w, d)), aux, attn1, attn2


class ReorderUpsample1d(nn.Module):
    """(B, S, d) -> (B, 2S, d/2) as a reshape, then a Dense and an LN
    (``jeju.py:135-147``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc = Linear(dim // 2, dim // 2)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        return self.norm(self.fc(x.reshape(b, 2 * s, d // 2)))


class SpatialUpsample2d(nn.Module):
    """Bilinear x2 (align corners), a replicate 3x3 conv to d/2 (with bias
    unless ``out_bn``), then an LN, or a BatchNorm (``norm.0``) and GELU
    (``jeju.py:150-175``)."""

    def __init__(self, dim: int, out_bn: bool = False):
        super().__init__()
        self.out_bn = out_bn
        self.conv = EdgeConv(dim, dim // 2, 3, bias=not out_bn)
        self.norm = nn.Sequential(BatchNorm(dim // 2)) if out_bn else LayerNorm(dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv(upsample2d(x, 2)))
        return gelu(y) if self.out_bn else y


class ODAJejuDecoder(nn.Module):
    """The Jeju decoder (``jeju.py:178-254``) over the encoder's
    ``enc_dims``: returns (the (B, H/2, W/2, 1) logits in the activation
    dtype, the final (B, 8 num_aux, channels / 8) aux tokens, the eight f32
    weights, attn1 then attn2, from 1/32 to 1/4). The aux bank is drawn
    truncated normal of std sqrt(1/channels)."""

    def __init__(self, enc_dims: Sequence[int], channels: int = 2048, num_aux: int = 128,
                 num_heads: int = 64, ppm_proj: int = 512, drop_prob: float = 0.1,
                 attn_drop_prob: float = 0.0):
        super().__init__()
        c = channels
        heads = [max(num_heads // 8, 1), max(num_heads // 4, 1), num_heads // 2, num_heads]
        self.aux = nn.Parameter(torch.zeros(1, num_aux, c))
        for i, d in enumerate(enc_dims):
            setattr(self, f"norm_f{i}", LayerNorm(d))
        self.ppm = PyramidPoolingModuleV2(enc_dims[3], ppm_proj, c)
        self.norm_ppm = LayerNorm(c)
        self.aux_drop = Dropout(drop_prob)
        for i, level in enumerate((32, 16, 8, 4)):
            dim = c >> i
            setattr(self, f"jeju{level}", JejuLayer(dim, enc_dims[3 - i], heads[3 - i],
                                                    attn_drop_prob, drop_prob))
            setattr(self, f"hidden_{level}to{level // 2}", SpatialUpsample2d(dim, level == 4))
            if level != 4:
                setattr(self, f"aux_{level}to{level // 2}", ReorderUpsample1d(dim))
        fc = c // 16
        self.out_conv = nn.Sequential(ConvBN(c // 16, fc, 3), ConvBN(fc, fc, 1),
                                      Conv1x1(fc, 1, bias=False))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.aux.data, math.sqrt(1.0 / self.aux.shape[-1]), generator)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        f4, f8, f16, f32 = (getattr(self, f"norm_f{i}")(f) for i, f in enumerate(features))
        hidden = self.norm_ppm(self.ppm(f32))
        c = self.aux.shape[-1]
        aux = self.aux_drop(self.aux.expand(hidden.shape[0], -1, -1).to(hidden.dtype),
                            generator)
        aux = aux * torch.tensor(math.sqrt(1.0 / c), dtype=aux.dtype)
        attns: Tuple[torch.Tensor, ...] = ()
        for level, enc in ((32, f32), (16, f16), (8, f8), (4, f4)):
            hidden, aux, attn1, attn2 = getattr(self, f"jeju{level}")(hidden, enc, aux,
                                                                       generator)
            attns += (attn1, attn2)
            hidden = getattr(self, f"hidden_{level}to{level // 2}")(hidden)
            if level != 4:
                aux = getattr(self, f"aux_{level}to{level // 2}")(aux)
        return self.out_conv(hidden), aux, attns


class ODAJejuModel(_ODABase):
    """``oda_jeju`` (``jeju.py:257-287``): returns (depth (B, H/2, W/2, 1) in
    f32 at the resized input's half scale, the final aux tokens, the eight
    weights)."""

    def __init__(self, decoder_channels: int = 2048, num_aux: int = 128, num_heads: int = 64,
                 min_depth: float = 0.001, max_depth: float = 80.0, drop_prob: float = 0.1,
                 attn_drop_prob: float = 0.0, out_func: str = "sigmoid",
                 resize_to_multiple: bool = True, img_size: Optional[Tuple[int, int]] = None,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, resize_to_multiple, img_size, use_checkpoint,
                         dtype, encoder_kwargs)
        self.out_func = out_func
        self.decoder = ODAJejuDecoder(self.encoder.backbone.num_features, decoder_channels,
                                      num_aux, num_heads, min(512, decoder_channels // 4),
                                      drop_prob, attn_drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        out, aux, attns = self.decoder(self.encoder(x, generator), generator)
        return apply_out_func(out, self.out_func, self.min_depth, self.max_depth), aux, attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``decoder_channels`` 2048, ``num_aux`` 128,
        ``num_heads`` 64, ``drop_prob`` 0.1, ``attn_drop_prob`` 0,
        ``out_func`` sigmoid unless given), and ``img_size``, which fixes
        the encoder's windows where the resize is off."""
        kwargs = dict(decoder_channels=opt.get("decoder_channels", 2048),
                      num_aux=opt.get("num_aux", 128), num_heads=opt.get("num_heads", 64),
                      min_depth=min_depth, max_depth=max_depth,
                      drop_prob=opt.get("drop_prob", 0.1),
                      attn_drop_prob=opt.get("attn_drop_prob", 0.0),
                      out_func=opt.get("out_func", "sigmoid"), img_size=opt.get("img_size"))
        kwargs.update(overrides)
        return cls(**kwargs)
