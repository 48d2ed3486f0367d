"""ODA2 Luna-gating models ``oda2_luna_reg`` and ``oda2_luna_cls``
(``mde_tpu/models/oda2/luna.py``).

A lateral-fusion pyramid whose fusions at 1/16, 1/8 and 1/4 are gated by
``ODA2LunaGating``: a 1x1 conv of the concatenated map, times the sigmoid of
per-pixel weights that a Luna layer computes from a bank of learned aux
tokens (aux self-attention, the aux tokens attending to the pixels, an FF,
then the pixels attending to the aux tokens, whose output projection
starts at zero), then a 1x1 conv, BatchNorm and GELU. The aux tokens carry
from one gate to the next. reg: a 1/4-scale sigmoid map. cls: ``num_aux``
bin probabilities a pixel, and bin widths from the aux tokens (ELU(0.1) +
0.1, normalised), decoded to the expected depth. The Luna attentions are
plain einsums, as in JAX (no kernel).

Parameter names follow the reference torch state dict, the names
``mde_tpu.core.family_converters.convert_oda2_luna_decoder``
(``:637-694``) converts from: ``aux``, ``ppm``, ``block32.{0,1}``,
``block{16,8,4}_lateral``, ``block{16,8,4}_gate`` with ``conv``,
``luna.{q,k,v,o}_{self,cross1,cross2}``, ``luna.norm_{self,cross1,ff}``,
``luna.ff.{0,3}``, ``conv_out``, ``norm_out``; ``block{16,8}.{0,1}``,
``block4.{0,1}`` and the cls head's ``bins.{0,2}``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.conv import Conv1x1, ConvBN
from ...ops.drop import Dropout
from ...ops.init import trunc_normal_
from ...ops.ppm import EdgeConv3x3, PyramidPoolingModule
from ...ops.reduction import attend
from ...ops.resize import upsample2d
from ...ops.tnn import BatchNorm, LayerNorm, Linear, gelu
from .base import SwinDepthModel


class ZeroInitLinear(Linear):
    """A Linear that starts at zero (JAX's ``zero_init`` Dense)."""

    def init_own_parameters(self, generator: torch.Generator) -> None:
        self.weight.data.zero_()
        self.bias.data.zero_()


class ODA2LunaLayer(nn.Module):
    """The Luna layer of a gate (``luna.py:34-100``) over a (B, H, W, C)
    map and (B, S, D) aux tokens, each step post-norm: aux self-attention
    (``{q,k,v,o}_self``, ``norm_self``); the aux tokens attending to the
    pixels (``*_cross1``, ``norm_cross1``); the FF ``ff.0`` -> GELU ->
    dropout -> ``ff.3`` -> dropout (``norm_ff``); then the pixels attending
    to the aux tokens (``*_cross2``), whose ``v_cross2`` has ``out_dims``
    channels and whose ``o_cross2`` starts at zero. Every attention's scale
    is the aux tokens' (D / heads)^-0.5; one dropout at ``drop_prob`` serves
    every step in call order. Returns (the aux tokens, (B, H, W,
    out_dims) gate weights)."""

    def __init__(self, in_dims: int, aux_dims: int, out_dims: int, num_heads: int,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1):
        super().__init__()
        if aux_dims % num_heads or out_dims % num_heads:
            raise ValueError(f"{aux_dims} and {out_dims} channels do not split into "
                             f"{num_heads} heads")
        d = aux_dims
        self.num_heads = num_heads
        self.scale = (d // num_heads) ** -0.5
        for step, q_in, kv_in, v_out in (("self", d, d, d), ("cross1", d, in_dims, d),
                                         ("cross2", in_dims, d, out_dims)):
            setattr(self, f"q_{step}", Linear(q_in, d))
            setattr(self, f"k_{step}", Linear(kv_in, d))
            setattr(self, f"v_{step}", Linear(kv_in, v_out))
            setattr(self, f"o_{step}", (ZeroInitLinear if step == "cross2" else Linear)(
                v_out, v_out))
        self.norm_self = LayerNorm(d)
        self.norm_cross1 = LayerNorm(d)
        # slots 1 and 2 (GELU and dropout, applied in forward) keep the
        # reference's index 3
        self.ff = nn.Sequential(Linear(d, 4 * d), nn.Identity(), nn.Identity(), Linear(4 * d, d))
        self.norm_ff = LayerNorm(d)
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)

    def _attend(self, step: str, q_in, kv_in, generator) -> torch.Tensor:
        out, _ = attend(getattr(self, f"q_{step}")(q_in), getattr(self, f"k_{step}")(kv_in),
                        getattr(self, f"v_{step}")(kv_in), self.num_heads, self.attn_drop,
                        generator, self.scale)
        return getattr(self, f"o_{step}")(out)

    def forward(self, x: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        aux = self.norm_self(aux + self.drop(self._attend("self", aux, aux, generator),
                                             generator))
        aux = self.norm_cross1(aux + self.drop(self._attend("cross1", aux, x, generator),
                                               generator))
        ff0, _, _, ff1 = self.ff
        y = self.drop(gelu(ff0(aux)), generator)
        aux = self.norm_ff(aux + self.drop(ff1(y), generator))
        wgt = self._attend("cross2", x, aux, generator)
        return aux, wgt.reshape(b, h, w, -1)


class ODA2LunaGating(nn.Module):
    """``conv`` (1x1, biased) of the map, times the sigmoid of the Luna
    layer's weights taken in the conv's dtype, then ``conv_out`` (1x1, no
    bias), ``norm_out`` (BatchNorm) and GELU (``luna.py:103-131``). Returns
    (the gated map, the aux tokens)."""

    def __init__(self, in_ch: int, out_channels: int, aux_dims: int, num_heads: int,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_channels, bias=True)
        self.luna = ODA2LunaLayer(in_ch, aux_dims, out_channels, num_heads, attn_drop_prob,
                                  drop_prob)
        self.conv_out = Conv1x1(out_channels, out_channels, bias=False)
        self.norm_out = BatchNorm(out_channels, eps=bn_eps, momentum=bn_momentum)

    def forward(self, x: torch.Tensor, aux: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_conv = self.conv(x)
        aux, wgt = self.luna(x, aux, generator)
        y = x_conv * torch.sigmoid(wgt.to(x_conv.dtype))
        return gelu(self.norm_out(self.conv_out(y))), aux


class ODA2LunaDecoder(nn.Module):
    """The reg and cls decoders (``luna.py:134-216``): the learned aux
    bank (drawn trunc_normal(sqrt(1/aux_dims)), used times sqrt(1/aux_dims)
    again); the PPM at 1/32 (512 channels a pooled size) and
    ``block32.{0,1}``; at 1/16, 1/8 and 1/4 a lateral ConvBN of the
    encoder's map to the width of the upsampled map, the concat, the gate,
    then ConvBNs; ``block4.1`` a biased 3x3 conv after a one-pixel edge
    pad. reg: (the f32 sigmoid map, None). cls: (the f32 softmax over
    ``num_aux`` bins, (B, num_aux) normalised bin widths), the widths from
    ``bins.0`` -> ReLU -> ``bins.2`` on the aux tokens in f32, as flax's
    Dense without a ``dtype`` computes them in a bf16 model too."""

    def __init__(self, enc_dims: Sequence[int], channels: int, num_aux: int, aux_dims: int,
                 num_heads: int, cls_head: bool = False, ppm_proj: int = 512,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        c = channels
        oc = [c // 8, c // 4, c // 2, c]
        c4, c8, c16, c32 = enc_dims
        ck = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
        gate = functools.partial(ODA2LunaGating, aux_dims=aux_dims, num_heads=num_heads,
                                 attn_drop_prob=attn_drop_prob, drop_prob=drop_prob, **ck)
        self.aux_dims = aux_dims
        self.cls_head = cls_head
        self.aux = nn.Parameter(torch.zeros(1, num_aux, aux_dims))
        self.ppm = PyramidPoolingModule(c32, ppm_proj, c, **ck)
        self.block32 = nn.Sequential(ConvBN(c, c, 3, **ck), ConvBN(c, c, 3, **ck))
        # lateral width = the incoming map's: oc[3], oc[2], oc[1]
        self.block16_lateral = ConvBN(c16, oc[3], 3, **ck)
        self.block16_gate = gate(2 * oc[3], oc[2])
        self.block16 = nn.Sequential(ConvBN(oc[2], oc[2], 3, **ck), ConvBN(oc[2], oc[2], 3, **ck))
        self.block8_lateral = ConvBN(c8, oc[2], 3, **ck)
        self.block8_gate = gate(2 * oc[2], oc[1])
        self.block8 = nn.Sequential(ConvBN(oc[1], oc[1], 3, **ck), ConvBN(oc[1], oc[1], 3, **ck))
        self.block4_lateral = ConvBN(c4, oc[1], 3, **ck)
        self.block4_gate = gate(2 * oc[1], oc[0])
        self.block4 = nn.Sequential(ConvBN(oc[0], oc[0], 3, **ck),
                                    EdgeConv3x3(oc[0], num_aux if cls_head else 1, bias=True))
        if cls_head:
            self.bins = nn.Sequential(Linear(aux_dims, aux_dims), nn.ReLU(),
                                      Linear(aux_dims, 1))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.aux.data, math.sqrt(1.0 / self.aux_dims), generator)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        f4, f8, f16, f32 = features
        aux = (self.aux.expand(f4.shape[0], -1, -1) * math.sqrt(1.0 / self.aux_dims)).to(f4.dtype)
        x = upsample2d(self.block32(self.ppm(f32)), 2)
        for level, skip in (("16", f16), ("8", f8)):
            y = torch.cat([x, getattr(self, f"block{level}_lateral")(skip)], dim=-1)
            y, aux = getattr(self, f"block{level}_gate")(y, aux, generator)
            x = upsample2d(getattr(self, f"block{level}")(y), 2)
        y = torch.cat([x, self.block4_lateral(f4)], dim=-1)
        y, aux = self.block4_gate(y, aux, generator)
        out = self.block4(y).float()
        if not self.cls_head:
            return torch.sigmoid(out), None
        widths = self.bins(aux.float())[..., 0]
        widths = torch.where(widths > 0, widths, 0.1 * (torch.exp(widths.clamp_max(0.0)) - 1.0))
        widths = widths + 0.1
        return out.softmax(dim=-1), widths / widths.sum(dim=-1, keepdim=True)


class ODA2LunaModel(SwinDepthModel):
    """Swin encoder + Luna-gated decoder (``luna.py:219-292``). ``forward``
    takes (B, H, W, 3) f32 images and returns ``(depth, None)`` (reg) or
    ``(depth, centers)`` (``cls_head``): one f32 map at 1/4 scale; reg
    ``sigmoid * (max_depth - min_depth) + min_depth``; cls the bin
    probabilities' expected value over the (B, num_aux) bin centers, the
    widths times the depth range after a first edge at ``min_depth``.
    ``dtype``, ``generator`` and ``use_checkpoint`` (the encoder only) as
    ``ODA2OrderedRegModel``'s."""

    def __init__(self, decoder_channels: int, min_depth: float, max_depth: float,
                 num_aux: int = 256, aux_dims: int = 256, num_heads: int = 8,
                 cls_head: bool = False, encoder_type: str = "large", drop_prob: float = 0.1,
                 attn_drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_checkpoint: bool = True, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.cls_head = cls_head
        self.decoder = ODA2LunaDecoder(
            self.encoder.num_features, decoder_channels, num_aux, aux_dims, num_heads,
            cls_head, attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
            bn_momentum=bn_momentum, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        out, second = self.decoder(self.features(x, generator), generator)
        span = self.max_depth - self.min_depth
        if not self.cls_head:
            return out * span + self.min_depth, None
        edges = torch.cumsum(F.pad(span * second, (1, 0), value=self.min_depth), dim=-1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return (out * centers[:, None, None, :]).sum(dim=-1, keepdim=True), centers

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, cls_head: bool = False,
              **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``luna.py:277-292``: ``decoder_channels`` falls
        back to ``dec_dim``, then 1024; 256 aux tokens of 256; 8 heads;
        dropout 0.1)."""
        kwargs = dict(
            decoder_channels=opt.get("decoder_channels", opt.get("dec_dim", 1024)),
            min_depth=min_depth, max_depth=max_depth, num_aux=opt.get("num_aux", 256),
            aux_dims=opt.get("aux_dim", opt.get("aux_dims", 256)),
            num_heads=opt.get("num_heads", 8), cls_head=cls_head,
            encoder_type=opt.get("encoder_type", "large"), drop_prob=opt.get("drop_prob", 0.1),
            attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
