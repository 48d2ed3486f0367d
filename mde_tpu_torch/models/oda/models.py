"""The ODA models (``mde_tpu/models/oda/models.py``): ``oda_conv``,
``oda_luna``, ``oda_luna_cls`` and ``oda_bins`` on the ODA Swin-L/w12
encoder (``encoder.py``).

- ``oda_conv``: the conv decoder; returns (depth, None).
- ``oda_luna``: the Luna decoder; returns (depth, aux tokens, 8 weights).
- ``oda_luna_cls``: the Luna decoder to ``num_bins`` logits, softmaxed in
  f32; the mean aux token regresses the bin widths through three f32
  Dense layers (GELU between) and ELU(0.1), normalised; the depth is the
  expected bin center. Returns (depth, aux, centers, weights).
- ``oda_bins``: the conv decoder to ``decoder_channels // 8`` channels and
  AdaBins' mViT head (embedding ``decoder_channels // 8``, 4 heads), a 1x1
  ``conv_out`` and the expected bin center. Returns (depth, edges).

The regression heads put the decoder's map through a sigmoid in f32 and
rescale it to (min_depth, max_depth). Every depth is an f32 (B, H/2, W/2,
1) map at the resized input's half scale. K1 runs in every encoder block
(24 a forward; the Luna attentions are plain einsums, as JAX's).

Parameter names: ``encoder.backbone.*``, ``decoder.*``
(``decoders.py``), ``bin_regressor.{0,2,4}``, ``adaptive_bins_layer.*``
(as AdaBins') and ``conv_out``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.conv import Conv1x1
from ...ops.tnn import Linear, gelu
from ..adabins.model import MiniViT
from .decoders import ODAConvDecoder, ODALunaDecoder
from .encoder import ODASwinEncoder


class _ODABase(nn.Module):
    """The ODA encoder (``encoder_kwargs``, ``resize_to_multiple``,
    ``img_size`` where the resize is off, ``use_checkpoint``, ``dtype``)
    and the depth range."""

    def __init__(self, min_depth: float, max_depth: float, resize_to_multiple: bool,
                 img_size: Optional[Tuple[int, int]], use_checkpoint: bool, dtype: torch.dtype,
                 encoder_kwargs: Optional[dict]):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.encoder = ODASwinEncoder(resize_to_multiple=resize_to_multiple,
                                      input_size=img_size, use_checkpoint=use_checkpoint,
                                      dtype=dtype, encoder_kwargs=encoder_kwargs)

    def rescale(self, out: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(out.float()) * (self.max_depth - self.min_depth) + self.min_depth

    def centers(self, widths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(edges, centers) of (B, n) normalised widths over the depth
        range, after a first edge at ``min_depth``."""
        widths = F.pad((self.max_depth - self.min_depth) * widths, (1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=-1)
        return edges, 0.5 * (edges[:, :-1] + edges[:, 1:])


def _common(opt, min_depth: float, max_depth: float) -> dict:
    return dict(decoder_channels=opt["decoder_channels"], min_depth=min_depth,
                max_depth=max_depth, img_size=opt.get("img_size"))


class ODAConvModel(_ODABase):
    """``oda_conv`` (``models.py:50-67``)."""

    def __init__(self, decoder_channels: int = 1024, min_depth: float = 0.001,
                 max_depth: float = 80.0, use_gn: bool = False, num_groups: int = 1,
                 resize_to_multiple: bool = True, img_size: Optional[Tuple[int, int]] = None,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, resize_to_multiple, img_size, use_checkpoint,
                         dtype, encoder_kwargs)
        self.decoder = ODAConvDecoder(self.encoder.backbone.num_features, decoder_channels,
                                      use_gn=use_gn, num_groups=num_groups)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.rescale(self.decoder(self.encoder(x, generator))), None

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``decoder_channels``)."""
        kwargs = _common(opt, min_depth, max_depth)
        kwargs.update(overrides)
        return cls(**kwargs)


class ODALunaModel(_ODABase):
    """``oda_luna`` (``models.py:70-101``), and with ``cls_head`` the
    decoder of ``oda_luna_cls`` (``:104-159``) to ``num_bins`` logits and
    its bin-width regressor ``bin_regressor.{0,2,4}``."""

    def __init__(self, decoder_channels: int = 1024, min_depth: float = 0.001,
                 max_depth: float = 80.0, num_aux: int = 256, aux_dim: int = 256,
                 num_heads: int = 8, num_bins: int = 256, cls_head: bool = False,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.1, use_gn: bool = False,
                 num_groups: int = 1, use_rp: bool = False, resize_to_multiple: bool = True,
                 img_size: Optional[Tuple[int, int]] = None, use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, resize_to_multiple, img_size, use_checkpoint,
                         dtype, encoder_kwargs)
        self.cls_head = cls_head
        self.decoder = ODALunaDecoder(
            self.encoder.backbone.num_features, decoder_channels, num_aux, aux_dim, num_heads,
            attn_drop_prob, drop_prob, num_bins if cls_head else 1, use_gn, num_groups, use_rp)
        if cls_head:  # GELU between, applied in forward (slots 1 and 3)
            self.bin_regressor = nn.Sequential(Linear(aux_dim, aux_dim), nn.Identity(),
                                               Linear(aux_dim, aux_dim), nn.Identity(),
                                               Linear(aux_dim, num_bins))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        out, aux, attns = self.decoder(self.encoder(x, generator), generator)
        if not self.cls_head:
            return self.rescale(out), aux, attns
        bin_cls = out.float().softmax(dim=-1)
        y = aux.float().mean(dim=1)
        fc0, _, fc1, _, fc2 = self.bin_regressor
        y = fc2(gelu(fc1(gelu(fc0(y)))))
        # F.elu(y, alpha=0.1), as JAX writes it
        widths = torch.where(y > 0, y, 0.1 * (torch.exp(y.clamp_max(0.0)) - 1.0))
        _, centers = self.centers(widths / widths.sum(dim=-1, keepdim=True))
        pred = (bin_cls * centers[:, None, None, :]).sum(dim=-1, keepdim=True)
        return pred, aux, centers, attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, cls_head: bool = False,
              **overrides):
        """As the JAX builds (``decoder_channels``, ``num_aux``, ``aux_dim``,
        ``num_heads``, cls ``num_bins``; dropout 0 and 0.1, no GroupNorm,
        no ``use_rp`` unless given)."""
        kwargs = dict(_common(opt, min_depth, max_depth), num_aux=opt["num_aux"],
                      aux_dim=opt["aux_dim"], num_heads=opt["num_heads"], cls_head=cls_head,
                      attn_drop_prob=opt.get("attn_drop_prob", 0.0),
                      drop_prob=opt.get("drop_prob", 0.1), use_gn=opt.get("use_gn", False),
                      num_groups=opt.get("num_groups", 1), use_rp=opt.get("use_rp", False))
        if cls_head:
            kwargs["num_bins"] = opt["num_bins"]
        kwargs.update(overrides)
        return cls(**kwargs)


class ODABinsModel(_ODABase):
    """``oda_bins`` (``models.py:162-203``); ``drop_prob`` is mViT's
    dropout, 0.1 as JAX's transformer layers fix it."""

    def __init__(self, decoder_channels: int = 1024, min_depth: float = 0.001,
                 max_depth: float = 80.0, num_bins: int = 256, drop_prob: float = 0.1,
                 resize_to_multiple: bool = True, img_size: Optional[Tuple[int, int]] = None,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, resize_to_multiple, img_size, use_checkpoint,
                         dtype, encoder_kwargs)
        e = decoder_channels // 8
        self.decoder = ODAConvDecoder(self.encoder.backbone.num_features, decoder_channels,
                                      output_channel=e)
        self.adaptive_bins_layer = MiniViT(e, num_bins, drop_prob, embedding_dim=e,
                                           num_heads=4)
        self.conv_out = Conv1x1(self.adaptive_bins_layer.n_queries, num_bins, bias=True)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        widths, maps = self.adaptive_bins_layer(self.decoder(self.encoder(x, generator)),
                                                generator)
        out = self.conv_out(maps).float().softmax(dim=-1)
        edges, centers = self.centers(widths)
        return (out * centers[:, None, None, :]).sum(dim=-1, keepdim=True), edges

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``decoder_channels``, ``num_bins``)."""
        kwargs = dict(_common(opt, min_depth, max_depth), num_bins=opt["num_bins"])
        kwargs.update(overrides)
        return cls(**kwargs)
