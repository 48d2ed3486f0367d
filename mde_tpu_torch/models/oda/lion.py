"""ODA Lion (``mde_tpu/models/oda/lion.py``): axial channel attention over
the ODA Swin-L/w12 encoder (``encoder.py``), and the output heads the
ODA Lion, Lime and Jeju models share.

Each ``LionLayer`` runs per row (the h pass), then per column (the w
pass): a pre-norm channel self-attention, the same with its keys and
values from the encoder's stage (``enc_norm``), and a conv FF (1x1 ->
5x5 replicate -> squeeze-excite -> 1x1, FF width d); then the reorder
upsample (channel quarters interleaved into 2x2 pixels, a 3x3 conv to
d/2) and an LN, or at the last layer a BatchNorm and GELU. A channel
attention's logits are q^T k over the n tokens of a row or column, (b,
L, d, d), scaled by 1/sqrt(n), softmaxed in f32 over the first channel
index; the f32 weights of the w pass are returned. The decoder stacks
four layers over a PPM-v2 at 1/32 plus a learned position embedding
``pe`` of the 1/32 grid, dropped with one mask for the whole batch.

JAX sizes ``pe`` by its first call (``Trainer.init_state`` by the first
train batch). The port fixes the grid at build from ``img_size`` (after
the 384-multiple resize where it runs) and refuses a call at another
grid: a model built for 352x704 (12x24) cannot run at 352x1216 (12x36),
as JAX's cannot.

The attentions are plain einsums in JAX, so they are here: no port
kernel lies on the decoders. K1 runs in the encoder's 24 blocks.

Parameter names follow the reference torch decoder, the names
``mde_tpu.core.family_converters.convert_oda_lion_decoder``
(``:412-425``) converts from: ``pe``, ``ppm``,
``lion{L}.{attn,cross_attn}_{h,w}.{norm,enc_norm,q_proj,k_proj,v_proj,o_proj}``,
``lion{L}.feed_forward_{h,w}.{norm,conv1.{0,1},conv2.{0,1},se.{0,2},conv3.0}``,
``lion{L}.upscale.conv``, ``lion{L}.out`` (the LN) or ``lion{L}.out.0``
(the BatchNorm), ``out_conv.{0,1}``.
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
from ...ops.tnn import BatchNorm, LayerNorm, Linear, gelu
from .models import _ODABase

def scaled_sigmoid(x: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """1 / (1 + alpha exp(-x / beta)) (``lime.py:31-33``)."""
    return 1.0 / (1.0 + alpha * torch.exp(-x / beta))


def apply_out_func(out: torch.Tensor, out_func: str, min_depth: float,
                   max_depth: float) -> torch.Tensor:
    """The ODA models' output heads in f32 (``lion.py:231-247``): a sigmoid,
    or the scaled sigmoid of alpha 4 or 1/4 (beta 1/2), rescaled to
    (min_depth, max_depth); or a ReLU times max_depth plus min_depth."""
    out = out.float()
    if out_func == "sigmoid":
        out = torch.sigmoid(out)
    elif out_func == "scaled_sigmoid":
        out = scaled_sigmoid(out, 4.0, 0.5)
    elif out_func == "inv_scaled_sigmoid":
        out = scaled_sigmoid(out, 0.25, 0.5)
    elif out_func == "relu":
        return torch.relu(out) * max_depth + min_depth
    else:
        raise ValueError(f"Unsupported out_func {out_func}.")
    return out * (max_depth - min_depth) + min_depth


def channel_attend(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor, attn_drop: Dropout,
                   generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel attention over (..., n, d) tokens, in JAX's order: the logits
    a^T b (..., d, d) in a's dtype times 1/sqrt(n), the softmax in f32 over
    the first channel index, its cast back, dropout, then v . P. Returns
    ((..., n, d), the f32 softmax)."""
    scale = torch.tensor(math.sqrt(1.0 / a.shape[-2]), dtype=a.dtype)
    weights = (torch.einsum("...nd,...ne->...de", a, b) * scale).float().softmax(dim=-2)
    attn = attn_drop(weights.to(a.dtype), generator)
    return torch.einsum("...nd,...de->...ne", v, attn), weights


class LionAxialAttention(nn.Module):
    """Pre-norm residual channel attention along H (``axis`` "h": one
    attention a row, over its W tokens) or W (a column, over its H
    tokens), with keys and values from the normed encoder map of
    ``enc_dim`` channels where given (``cross``) (``lion.py:35-79``).
    Returns (the map, the f32 (B, L, d, d) weights)."""

    def __init__(self, dim: int, axis: str = "h", enc_dim: Optional[int] = None,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1):
        super().__init__()
        if axis not in ("h", "w"):
            raise ValueError(f"axis {axis!r} is not 'h' or 'w'")
        self.axis = axis
        self.cross = enc_dim is not None
        self.norm = LayerNorm(dim)
        if self.cross:
            self.enc_norm = LayerNorm(enc_dim)
        src = enc_dim if self.cross else dim
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(src, dim)
        self.v_proj = Linear(src, dim)
        self.o_proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def forward(self, hidden: torch.Tensor, enc: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.norm(hidden)
        src = self.enc_norm(enc) if self.cross else x
        if self.axis == "w":
            x, src = x.transpose(1, 2), src.transpose(1, 2)
        out, weights = channel_attend(self.q_proj(x), self.k_proj(src), self.v_proj(src),
                                      self.attn_drop, generator)
        out = self.drop(self.o_proj(out), generator)
        return (out.transpose(1, 2) if self.axis == "w" else out) + hidden, weights


class ConvSEBody(nn.Module):
    """The FF body of Lion and Jeju: 1x1 conv + BatchNorm + GELU -> 5x5
    replicate conv (``groups``) + BatchNorm + GELU -> squeeze-excite (the
    pixel mean, a Dense to ``se_dim``, GELU, a Dense back, a sigmoid gate
    on the map); ``conv3`` is the owner's."""

    def __init__(self, dim: int, ff: int, se_dim: int, groups: int = 1,
                 bn_momentum: float = 0.1):
        super().__init__()
        self.conv1 = nn.Sequential(Conv1x1(dim, ff, bias=False),
                                   BatchNorm(ff, momentum=bn_momentum))
        self.conv2 = nn.Sequential(EdgeConv(ff, ff, 5, groups=groups),
                                   BatchNorm(ff, momentum=bn_momentum))
        self.se = nn.Sequential(Linear(ff, se_dim), nn.Identity(), Linear(se_dim, ff))

    def body(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(self.conv2(gelu(self.conv1(x))))
        s = self.se[2](gelu(self.se[0](y.mean(dim=(1, 2)))))
        return y * torch.sigmoid(s)[:, None, None, :]


class LionFeedForwardConv(ConvSEBody):
    """Pre-norm residual conv FF (``lion.py:82-123``): LN, the body at FF
    width ``feedforward_dim`` (default 4 d; the Lion layer passes d) with
    squeeze-excite to a quarter, a 1x1 ``conv3`` with bias, dropout."""

    def __init__(self, dim: int, feedforward_dim: Optional[int] = None, drop_prob: float = 0.1,
                 bn_momentum: float = 0.1):
        ff = feedforward_dim or 4 * dim
        super().__init__(dim, ff, ff // 4, bn_momentum=bn_momentum)
        self.norm = LayerNorm(dim)
        self.conv3 = nn.Sequential(Conv1x1(ff, dim, bias=True))
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.drop(self.conv3(self.body(self.norm(x))), generator) + x


def lion_reorder_interleave(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, d) -> (B, 2H, 2W, d/4): channel quarter g goes to the pixel
    (row g % 2, column g // 2) of each 2x2 block (``lion.py:126-137``)."""
    b, h, w, d = x.shape
    if d % 4:
        raise ValueError(f"{d} channels do not split into quarters")
    g = x.reshape(b, h, w, 2, 2, d // 4).permute(0, 1, 4, 2, 3, 5)
    return g.reshape(b, 2 * h, 2 * w, d // 4)


class LionReorder(nn.Module):
    """The interleave, then a bias-free replicate 3x3 conv to d/2."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = EdgeConv(dim // 4, dim // 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(lion_reorder_interleave(x))


class LionLayer(nn.Module):
    """The h pass (self, cross, FF), the w pass, the reorder upsample to d/2,
    then an LN, or where ``last_block`` a BatchNorm (``out.0``) and GELU
    (``lion.py:152-198``). Returns (the map, the w pass's self and cross
    weights)."""

    def __init__(self, dim: int, enc_dim: int, last_block: bool = False,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1, bn_momentum: float = 0.1):
        super().__init__()
        ak = dict(attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)
        for axis in ("h", "w"):
            setattr(self, f"attn_{axis}", LionAxialAttention(dim, axis, **ak))
            setattr(self, f"cross_attn_{axis}", LionAxialAttention(dim, axis, enc_dim, **ak))
            setattr(self, f"feed_forward_{axis}",
                    LionFeedForwardConv(dim, dim, drop_prob, bn_momentum))
        self.upscale = LionReorder(dim)
        self.last_block = last_block
        self.out = (nn.Sequential(BatchNorm(dim // 2, momentum=bn_momentum)) if last_block
                    else LayerNorm(dim // 2))

    def forward(self, hidden: torch.Tensor, enc: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        for axis in ("h", "w"):
            hidden, attn = getattr(self, f"attn_{axis}")(hidden, generator=generator)
            hidden, cross = getattr(self, f"cross_attn_{axis}")(hidden, enc, generator)
            hidden = getattr(self, f"feed_forward_{axis}")(hidden, generator)
        hidden = self.out(self.upscale(hidden))
        return (gelu(hidden) if self.last_block else hidden), attn, cross


class ODALionDecoder(nn.Module):
    """The Lion decoder (``lion.py:250-288``) over the encoder's ``enc_dims``
    at the 1/32 ``grid``: returns (the (B, H/2, W/2, 1) logits in the
    activation dtype, the eight f32 weights, self then cross, from 1/32 to
    1/4). ``pe`` is drawn truncated normal of std sqrt(1/channels)."""

    def __init__(self, enc_dims: Sequence[int], channels: int, grid: Tuple[int, int],
                 ppm_proj: int = 512, drop_prob: float = 0.1, attn_drop_prob: float = 0.0):
        super().__init__()
        c = channels
        self.grid = (int(grid[0]), int(grid[1]))
        self.pe = nn.Parameter(torch.zeros(*self.grid, c))
        self.ppm = PyramidPoolingModuleV2(enc_dims[3], ppm_proj, c)
        self.pe_drop = Dropout(drop_prob, batched=False)  # (1, h, w, c): no batch
        for i, level in enumerate((32, 16, 8, 4)):
            setattr(self, f"lion{level}",
                    LionLayer(c >> i, enc_dims[3 - i], level == 4, attn_drop_prob, drop_prob))
        self.out_conv = nn.Sequential(ConvBN(c // 16, c // 16, 3),
                                      Conv1x1(c // 16, 1, bias=False))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pe.data, math.sqrt(1.0 / self.pe.shape[-1]), generator)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        f4, f8, f16, f32 = features
        hidden = self.ppm(f32)
        hidden = hidden + self.pe_drop(self.pe[None].to(hidden.dtype), generator)
        attns: Tuple[torch.Tensor, ...] = ()
        for level, enc in ((32, f32), (16, f16), (8, f8), (4, f4)):
            hidden, attn, cross = getattr(self, f"lion{level}")(hidden, enc, generator)
            attns += (attn, cross)
        return self.out_conv(hidden), attns


class ODALionModel(_ODABase):
    """``oda_lion`` (``lion.py:291-325``): returns (depth (B, H/2, W/2, 1) in
    f32 at the resized input's half scale, the eight weights). ``img_size``
    is required: it fixes ``pe``'s grid."""

    def __init__(self, decoder_channels: int = 2048, min_depth: float = 0.001,
                 max_depth: float = 80.0, drop_prob: float = 0.1, attn_drop_prob: float = 0.0,
                 out_func: str = "sigmoid", resize_to_multiple: bool = True,
                 img_size: Optional[Tuple[int, int]] = None, use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        if img_size is None:
            raise ValueError("oda_lion needs img_size: its position embedding has the shape "
                             "of the encoder's 1/32 grid, which JAX takes from its first call")
        super().__init__(min_depth, max_depth, resize_to_multiple, img_size, use_checkpoint,
                         dtype, encoder_kwargs)
        self.out_func = out_func
        self.decoder = ODALionDecoder(self.encoder.backbone.num_features, decoder_channels,
                                      self.encoder.grid(img_size),
                                      min(512, decoder_channels // 4), drop_prob, attn_drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        grid = self.encoder.grid(x.shape[1:3])
        if grid != self.decoder.grid:
            raise ValueError(f"oda_lion's position embedding was built for the 1/32 grid "
                             f"{self.decoder.grid}; a {x.shape[1]}x{x.shape[2]} input gives "
                             f"{grid} (build the model with this img_size)")
        out, attns = self.decoder(self.encoder(x, generator), generator)
        return apply_out_func(out, self.out_func, self.min_depth, self.max_depth), attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``decoder_channels`` 2048, ``drop_prob`` 0.1,
        ``attn_drop_prob`` 0, ``out_func`` sigmoid unless given), and
        ``img_size``."""
        kwargs = dict(decoder_channels=opt.get("decoder_channels", 2048), min_depth=min_depth,
                      max_depth=max_depth, drop_prob=opt.get("drop_prob", 0.1),
                      attn_drop_prob=opt.get("attn_drop_prob", 0.0),
                      out_func=opt.get("out_func", "sigmoid"), img_size=opt.get("img_size"))
        kwargs.update(overrides)
        return cls(**kwargs)
