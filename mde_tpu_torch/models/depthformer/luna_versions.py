"""Depthformer v6, v7 and v8 (``mde_tpu/models/depthformer/luna_versions.py``):
Luna decoders with AdaBins-style global bins on EfficientNet-B5.

Top-down from 1/32 to 1/2, each scale a residual ConvBN block (of the
upsampled map concatenated after the encoder's, then the activation),
then a Luna layer whose aux token bank (``aux_embedding``, (1, num_aux,
d)) carries from scale to scale; at 1/2 no Luna. A conv head softmaxes
over ``num_bins`` classes, the mean aux token regresses the bin widths in
f32, and the depth is the expected bin center. The version deltas, kept
as JAX keeps them (``:11-28``):

- v6: GELU, post-norm Luna; the aux bank scaled by sqrt(1/d) at the start;
  two residual blocks a scale; 1x1 ``shoot`` projections (d/8) after the
  Luna layers, resized to 1/2 and concatenated for the head; a final
  ``LunaHalfBlock`` on the 1/2-scale map updates the aux tokens; ReLU +
  0.1 bin widths. Returns (depth, 9 attention weights).
- v7: SiLU, pre-norm Luna; ``num_aux`` = (H/32)(W/32) of ``img_size``; a
  learned ``position_embedding`` on the 1/32 map (stored NCHW, as the
  reference's); dropout on every encoder input; an aux ViT after each Luna
  layer and one at the end, then ``aux_lst_ln``; no shoots: the head is a
  ConvBN and a 1x1 conv on the 1/2-scale map; EfficientNet tap 12 (its
  2048-channel ``conv_head``); ReLU + 0.1 widths. Returns (depth, bin
  centers, 8 weights).
- v8: SiLU, pre-norm Luna; shoots before the Luna layers; one aux ViT
  after the last Luna layer; dropout in the width regressor; ELU(0.1) + 0.1
  widths. Returns (depth, centers, 8 weights).

The attentions are plain einsums, as JAX's are: no kernel of the port lies
on these paths. Parameter names follow the reference torch decoders, the
names ``mde_tpu.core.family_converters.convert_depthformer_luna_decoder``
(``:192-263``) converts from: ``aux_embedding``, ``position_embedding``,
``luna_layers.{i}``, ``luna_final``, ``aux_layers.{i}``, ``aux_lst_ln``,
``aux_layer``, ``post_conv_layers.{i}[.{j}]``, ``shoot_layers.{i}``,
``bin_regressor.{0,2,4}`` (v8 ``{0,3,6}``), ``bin_predictor.{0,1[,2]}``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.conv import Conv1x1
from ...ops.drop import Dropout
from ...ops.luna import LunaHalfBlock, LunaLayer
from ...ops.resize import resize_bilinear
from ...ops.tnn import LayerNorm, Linear, gelu
from .layers import ConvBN, ResConvBNBlock, ViTLayer, upscale_concat_act
from .model import TAPS, EfficientNetDepthModel


class DepthFormerLunaDecoder(nn.Module):
    """The v6, v7 and v8 decoder (``luna_versions.py:55-225``) over the five
    taps' maps of ``enc_channels``; returns (the (B, num_bins) f32
    normalised bin widths, the f32 softmax over the bins at 1/2 scale, the
    Luna attentions' f32 weights)."""

    def __init__(self, version: int, enc_channels: Sequence[int], hidden_dim: int,
                 num_heads: int, num_bins: int, num_aux: int, img_size: Tuple[int, int],
                 feedforward_dim: Optional[int] = None, attn_drop_prob: float = 0.1,
                 drop_prob: float = 0.1):
        super().__init__()
        if version not in (6, 7, 8):
            raise ValueError(f"DepthFormerLunaDecoder builds versions 6-8, not {version}")
        d, nh = hidden_dim, num_heads
        self.version = version
        self.act = gelu if version == 6 else F.silu
        if version == 6:
            idims = [d // 4, d // 2, d // 2, d, d]
            iheads = [nh // 4, nh // 2, nh // 2, nh, nh]
        elif version == 7:
            idims = [d // 8, d // 8, d // 4, d // 2, d]
            iheads = [nh // 8, nh // 8, nh // 4, nh // 2, nh]
            # overridden to the 1/32 token count (decoder_v7.py:42)
            num_aux = (img_size[0] // 32) * (img_size[1] // 32)
        else:
            idims = [d // 4, d // 4, d // 2, d // 2, d]
            iheads = [nh // 4, nh // 4, nh // 2, nh // 2, nh]
        iheads = [max(h, 1) for h in iheads]
        ins = [c + (idims[i + 1] if i < 4 else 0) for i, c in enumerate(enc_channels)]
        self.aux_embedding = nn.Parameter(torch.zeros(1, num_aux, d))
        if version == 7:
            grid = (-(-img_size[0] // 32), -(-img_size[1] // 32))
            self.position_embedding = nn.Parameter(torch.zeros(1, d, *grid))
            self.enc_drop = Dropout(drop_prob)
        blocks = 2 if version == 6 else 1
        self.post_conv_layers = nn.ModuleList(
            nn.Sequential(*(ResConvBNBlock(ins[i] if j == 0 else idims[i], idims[i], 3,
                                           act=self.act) for j in range(blocks)))
            if blocks > 1 else ResConvBNBlock(ins[i], idims[i], 3, act=self.act)
            for i in range(5))
        self.luna_layers = nn.ModuleList(
            LunaLayer(idims[i + 1], d, idims[i + 1], iheads[i + 1], pre_norm=version >= 7,
                      feedforward_dim=feedforward_dim, attn_drop_prob=attn_drop_prob,
                      drop_prob=drop_prob, act=self.act) for i in range(4))

        def vit():
            return ViTLayer(d, num_heads=nh, feedforward_dim=feedforward_dim,
                            attn_drop_prob=attn_drop_prob, drop_prob=drop_prob, act=self.act)

        if version == 6:
            self.luna_final = LunaHalfBlock(idims[0], d, idims[0], iheads[0], attn_drop_prob,
                                            drop_prob)
        elif version == 7:
            # aux_layers.{i + 1} follows luna_layers.{i}, aux_layers.0 the last
            self.aux_layers = nn.ModuleList(vit() for _ in range(5))
            self.aux_lst_ln = LayerNorm(d)
        else:
            self.aux_layer = vit()
        if version != 7:
            self.shoot_layers = nn.ModuleList(
                ConvBN(idims[i], d // 8, 1, act=self.act, use_residual=False)
                for i in range(5))
        # the regressor's activations (and v8's dropouts) apply in forward:
        # slots 1, 3 (v8: 1, 2, 4, 5) keep the reference's indices
        slot = nn.Identity
        if version == 8:
            self.bin_regressor = nn.Sequential(Linear(d, d), slot(), slot(), Linear(d, d),
                                               slot(), slot(), Linear(d, num_bins))
            self.regressor_drop = Dropout(drop_prob)
        else:
            self.bin_regressor = nn.Sequential(Linear(d, d), slot(), Linear(d, d), slot(),
                                               Linear(d, num_bins))
        if version == 6:
            self.bin_predictor = nn.Sequential(
                ResConvBNBlock(5 * (d // 8), d // 2, 3, act=self.act),
                Conv1x1(d // 2, num_bins, bias=True))
        elif version == 7:
            self.bin_predictor = nn.Sequential(
                ConvBN(idims[0], idims[0], 3, act=self.act, use_residual=False),
                Conv1x1(idims[0], num_bins, bias=True))
        else:
            self.bin_predictor = nn.Sequential(
                ConvBN(5 * (d // 8), d, 3, act=self.act, use_residual=False),
                ConvBN(d, d, 3, act=self.act, use_residual=False),
                Conv1x1(d, num_bins, bias=True))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        d = self.aux_embedding.shape[-1]
        self.aux_embedding.data.normal_(0.0, math.sqrt(1.0 / d), generator=generator)
        if self.version == 7:
            self.position_embedding.data.normal_(0.0, math.sqrt(1.0 / d), generator=generator)

    def _luna(self, i: int, x: torch.Tensor, aux: torch.Tensor, attns: tuple, generator):
        x, aux, a1, a2 = self.luna_layers[i](x, aux, generator)
        if self.version == 7:
            aux, _ = self.aux_layers[i + 1](aux, generator)
        return x, aux, (a1, a2) + attns

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        v = self.version
        if v == 7:
            features = [self.enc_drop(x, generator) for x in features]
        x0, x1, x2, x3, x4 = features
        b, d = x0.shape[0], self.aux_embedding.shape[-1]
        aux = self.aux_embedding.expand(b, -1, -1).to(x0.dtype)
        if v == 6:  # decoder_v6.py:129
            aux = aux * math.sqrt(1.0 / d)
        outs = [None] * 5
        c = self.post_conv_layers[4](x4)
        if v == 7:
            pe = self.position_embedding
            if c.shape[1:3] != pe.shape[2:]:
                raise ValueError(f"a {c.shape[1]}x{c.shape[2]} map at 1/32 against a "
                                 f"{pe.shape[2]}x{pe.shape[3]} position embedding: the model "
                                 f"was built for another img_size")
            c = c + pe.permute(0, 2, 3, 1).to(c.dtype)
        if v == 8:
            outs[4] = self.shoot_layers[4](c)
        c, aux, attns = self._luna(3, c, aux, (), generator)
        if v == 6:
            outs[4] = self.shoot_layers[4](c)
        for i, skip in ((3, x3), (2, x2), (1, x1), (0, x0)):
            if i == 0 and v == 8:
                aux, _ = self.aux_layer(aux, generator)
            c = self.post_conv_layers[i](upscale_concat_act(skip, c, 2, act=self.act))
            if v == 8:
                outs[i] = self.shoot_layers[i](c)
            if i > 0:
                c, aux, attns = self._luna(i - 1, c, aux, attns, generator)
            if v == 6:
                outs[i] = self.shoot_layers[i](c)
        if v == 6:
            aux, a0 = self.luna_final(c, aux, generator)
            attns = (a0,) + attns
        if v == 7:
            aux, _ = self.aux_layers[0](aux, generator)
            aux = self.aux_lst_ln(aux)
            y = self.bin_predictor(c)
        else:
            hw = x0.shape[1:3]
            y = self.bin_predictor(torch.cat(
                [outs[0]] + [resize_bilinear(o, hw, align_corners=True) for o in outs[1:]],
                dim=-1))
        bin_cls = y.float().softmax(dim=-1)
        w = aux.float().mean(dim=1)
        lin = [m for m in self.bin_regressor if isinstance(m, Linear)]
        for layer in lin[:2]:
            w = layer(w)
            if v == 8:
                w = self.regressor_drop(w, generator)
            w = self.act(w)
        w = lin[2](w)
        if v == 8:  # "log-domain bin estimation" (decoder_v8.py:166)
            w = torch.where(w > 0, w, 0.1 * (torch.exp(w.clamp_max(0.0)) - 1.0)) + 0.1
        else:
            w = F.relu(w) + 0.1
        return w / w.sum(dim=1, keepdim=True), bin_cls, attns


class DepthformerLuna(EfficientNetDepthModel):
    """v6, v7 and v8 (``luna_versions.py:228-284``): ``forward`` takes (B,
    H, W, 3) f32 images and returns ``(depth, attns)`` (v6) or ``(depth,
    centers, attns)`` (v7, v8): the f32 (B, H/2, W/2, 1) expected depth
    over the bins, the (B, num_bins) f32 bin centers (the widths times the
    depth range after a first edge at ``min_depth``), and the Luna
    layers' f32 attention weights (v6 first the final half block's)."""

    def __init__(self, version: int, hidden_dim: int, num_heads: int, num_bins: int,
                 num_aux: int, img_size: Tuple[int, int], min_depth: float = 0.001,
                 max_depth: float = 80.0, attn_drop_prob: float = 0.1, drop_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        if version not in (6, 7, 8):
            raise ValueError(f"DepthformerLuna builds versions 6-8, not {version}")
        # v7 keeps conv_head (tap 12, 2048 channels); v6 and v8 drop it (tap 10)
        super().__init__(min_depth, max_depth, version == 7, dtype, encoder_kwargs)
        self.version = version
        self.taps = TAPS[:4] + ((12,) if version == 7 else (10,))
        self.decoder = DepthFormerLunaDecoder(
            version, [self.encoder.channels[i] for i in self.taps], hidden_dim, num_heads,
            num_bins, num_aux, img_size, attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        widths, bin_cls, attns = self.decoder(self.features(x, self.taps), generator)
        widths = F.pad((self.max_depth - self.min_depth) * widths, (1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        pred = (bin_cls * centers[:, None, None, :]).sum(dim=-1, keepdim=True)
        return (pred, attns) if self.version == 6 else (pred, centers, attns)

    @classmethod
    def build(cls, version: int, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section as the JAX build does
        (``hidden_dim``, ``num_heads``, ``num_bins``, ``num_aux``,
        ``img_size``; dropout 0.1 and 0.1 unless given)."""
        kwargs = dict(version=version, hidden_dim=opt["hidden_dim"], num_heads=opt["num_heads"],
                      num_bins=opt["num_bins"], num_aux=opt["num_aux"],
                      img_size=tuple(opt["img_size"]), min_depth=min_depth,
                      max_depth=max_depth, attn_drop_prob=opt.get("attn_drop_prob", 0.1),
                      drop_prob=opt.get("drop_prob", 0.1))
        kwargs.update(overrides)
        return cls(**kwargs)
