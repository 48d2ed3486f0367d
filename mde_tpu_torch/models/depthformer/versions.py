"""Depthformer v2, v3, v4 and v5 (``mde_tpu/models/depthformer/versions.py``).

- v2 (``depthformer_v2``): pre-norm ViT layers over the full token grids
  at 1/32, 1/16 and 1/8, each with its own learned position embedding;
  widths (d/16, d/4, d) with (heads/4, heads/2, heads); 3x3 ConvBNBlocks;
  a sigmoid 1x1 head at 1/2 scale. Returns (depth, the three scales'
  (B, heads, N, N) f32 attention weights).
- v5 (``depthformer_v5``): v2 on EfficientNet tap 12 (the 2048-channel
  head after SiLU), ViT widths (d/4, d/2, d) with key-query widths
  (kq/16, kq/4, kq), ConvBNBlock widths (d/16, d/8, d/4, d/2, d).
- v3 (``depthformer_v3``): the v2 skeleton with a 128-channel ReLU range
  map as its head, bin widths regressed in f32 from the mean of the 1/32
  map, a 1x1 ``conv_out`` to ``num_bins`` and AdaBins' expected-value
  decode. Returns (depth, bin edges, attention weights).
- v4 (``depthformer_v4``): one depth cls token attends to each scale
  (per-head dot products with 1x1-conv keys and values), is updated through
  a Linear and a LayerNorm, and gates the values through a sigmoid FF; a
  hard-sigmoid head. Returns (depth, the five (B, heads, N) f32 weights).

Every attention is plain einsums, as JAX's are: no kernel of the port lies
on these paths.

Parameter names follow the reference torch decoders, the names
``mde_tpu.core.family_converters.convert_depthformer_v2_decoder``
(``:159-188``, v2 and v5) and ``convert_depthformer_v4_decoder``
(``:127-151``) convert from: ``position_embeddings.{i}``,
``vit_layers.{i}``, ``vit_bn_layers.{i}``, ``post_conv_layers.{i}``,
``final_block.0``; v4's ``depth_cls``, ``{q,k,v}_projections.{i}``,
``post_cls_layers.{i}``, ``post_cls_ln.{i}``,
``cls_to_weight_layers.{i}.{0,3}``, ``post_weight_layers.{i}``,
``final_block.{1,2}``. v3 has no converter (its upstream decoder does not
construct, ``docs/PARITY.md:133``); its regressor is ``regressor.{0,2,4}``
as AdaBins' is, and ``conv_out`` sits beside the decoder.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.conv import Conv1x1
from ...ops.drop import Dropout
from ...ops.init import xavier_normal_
from ...ops.tnn import BatchNorm, LayerNorm, Linear, gelu
from .layers import ConvBN, ConvBNBlock, ResConvBNBlock, ViTLayer, upscale_concat_act
from .model import TAPS, EfficientNetDepthModel


class DepthFormerDecoderV2(nn.Module):
    """The v2 decoder (``versions.py:39-131``), also v5's (``v5_dims``) and
    v3's (``range_map``), over the five taps' maps of ``enc_channels``;
    ``img_size`` sets the token grids of the position embeddings."""

    def __init__(self, enc_channels: Sequence[int], hidden_dim: int, num_heads: int,
                 img_size: Tuple[int, int], key_query_dim: Optional[int] = None,
                 v5_dims: bool = False, num_repeat: int = 1, attn_drop_prob: float = 0.1,
                 drop_prob: float = 0.1, range_map: bool = False):
        super().__init__()
        d, nh = hidden_dim, num_heads
        if v5_dims:
            kq = key_query_dim or d
            kq_dims = [kq // 16, kq // 4, kq]
            # v5's ConvBNBlocks are finer than its ViT widths (d/4, d/2, d)
            out_dims = [d // 16, d // 8, d // 4, d // 2, d]
        else:
            kq_dims = [None, None, None]
            out_dims = [d // 16, d // 16, d // 16, d // 4, d]
        vit_heads = [max(nh // 4, 1), max(nh // 2, 1), nh]
        self.range_map = range_map
        ins = [c + (out_dims[i + 1] if i < 4 else 0) for i, c in enumerate(enc_channels)]
        self.post_conv_layers = nn.ModuleList(ConvBNBlock(ins[i], out_dims[i], 3)
                                              for i in range(5))
        # ViT i runs at stride 8 * 2^i on ConvBNBlock i + 2's map
        self.position_embeddings = nn.ParameterList(
            torch.zeros(-(-img_size[0] // (8 << i)) * -(-img_size[1] // (8 << i)),
                        out_dims[i + 2]) for i in range(3))
        self.vit_layers = nn.ModuleList(
            ViTLayer(out_dims[i + 2], kq_dims[i], vit_heads[i], num_repeat,
                     attn_drop_prob=attn_drop_prob, drop_prob=drop_prob) for i in range(3))
        self.vit_bn_layers = nn.ModuleList(BatchNorm(out_dims[i + 2]) for i in range(3))
        self.final_block = nn.Sequential(Conv1x1(out_dims[0], 128 if range_map else 1,
                                                 bias=True))
        if range_map:
            self.regressor = nn.Sequential(Linear(d, 256), nn.LeakyReLU(0.01), Linear(256, 256),
                                           nn.LeakyReLU(0.01), Linear(256, 256))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        for pe in self.position_embeddings:
            xavier_normal_(pe.data, generator)

    def _vit(self, i: int, x: torch.Tensor, generator) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = x.shape
        pe = self.position_embeddings[i]
        if h * w != pe.shape[0]:
            raise ValueError(f"a {h}x{w} token grid against {pe.shape[0]} position embeddings: "
                             f"the model was built for another img_size")
        t, attn = self.vit_layers[i](x.reshape(b, h * w, c) + pe.to(x.dtype), generator)
        return self.vit_bn_layers[i](t.reshape(b, h, w, c)), attn

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        x0, x1, x2, x3, x4 = features
        feat4, attn4 = self._vit(2, self.post_conv_layers[4](x4), generator)
        c3 = self.post_conv_layers[3](upscale_concat_act(x3, feat4, 2, act=None))
        feat3, attn3 = self._vit(1, c3, generator)
        c2 = self.post_conv_layers[2](upscale_concat_act(x2, feat3, 2, act=None))
        feat2, attn2 = self._vit(0, c2, generator)
        c1 = self.post_conv_layers[1](upscale_concat_act(x1, feat2, 2, act=None))
        c0 = self.post_conv_layers[0](upscale_concat_act(x0, c1, 2, act=None))
        attns = (attn2, attn3, attn4)
        if not self.range_map:
            return torch.sigmoid(self.final_block(c0).float()), attns
        # v3: the range map, and bin widths from the mean of the 1/32 map in f32
        widths = F.relu(self.regressor(feat4.float().mean(dim=(1, 2)))) + 0.1
        return ((F.relu(self.final_block(c0)), widths / widths.sum(dim=1, keepdim=True)),
                attns)


class DepthformerV2(EfficientNetDepthModel):
    """v2 (``version`` 2) and v5 (``version`` 5) (``versions.py:134-181``):
    ``forward`` takes (B, H, W, 3) f32 images of ``img_size`` and returns
    ``(depth, (attn2, attn3, attn4))``, the f32 (B, H/2, W/2, 1) depth
    and the 1/8, 1/16 and 1/32 scales' f32 attention weights."""

    def __init__(self, hidden_dim: int, num_heads: int, img_size: Tuple[int, int],
                 version: int = 2, key_query_dim: Optional[int] = None,
                 min_depth: float = 0.001, max_depth: float = 80.0, num_repeat: int = 1,
                 attn_drop_prob: float = 0.1, drop_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        if version not in (2, 5):
            raise ValueError(f"DepthformerV2 builds versions 2 and 5, not {version}")
        super().__init__(min_depth, max_depth, version == 5, dtype, encoder_kwargs)
        self.taps = TAPS[:4] + ((12,) if version == 5 else (10,))
        self.decoder = DepthFormerDecoderV2(
            [self.encoder.channels[i] for i in self.taps], hidden_dim, num_heads, img_size,
            key_query_dim, version == 5, num_repeat, attn_drop_prob, drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        out, attn = self.decoder(self.features(x, self.taps), generator)
        return self.rescale(out), attn

    @classmethod
    def build(cls, version: int, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section as the JAX build
        does (``hidden_dim``, ``num_heads``, ``img_size``,
        ``key_query_dim``; ``num_repeat`` 1, dropout 0.1 and 0.1 unless
        given)."""
        kwargs = dict(version=version, hidden_dim=opt["hidden_dim"], num_heads=opt["num_heads"],
                      img_size=tuple(opt["img_size"]), key_query_dim=opt.get("key_query_dim"),
                      min_depth=min_depth, max_depth=max_depth,
                      num_repeat=opt.get("num_repeat", 1),
                      attn_drop_prob=opt.get("attn_drop_prob", 0.1),
                      drop_prob=opt.get("drop_prob", 0.1))
        kwargs.update(overrides)
        return cls(**kwargs)


class DepthformerV3(EfficientNetDepthModel):
    """v3 (``versions.py:184-238``): ``forward`` returns ``(depth, edges,
    (attn2, attn3, attn4))``: the f32 expected depth over ``num_bins``
    bins (the f32 softmax of ``conv_out`` of the range map), the (B,
    num_bins + 1) f32 edges (the regressed widths cut to ``num_bins``, or
    padded with 1e-3, times the depth range, after a first edge at
    ``min_depth``), and the attention weights."""

    def __init__(self, hidden_dim: int, num_heads: int, img_size: Tuple[int, int],
                 num_bins: int = 100, min_depth: float = 0.001, max_depth: float = 80.0,
                 attn_drop_prob: float = 0.1, drop_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, False, dtype, encoder_kwargs)
        self.num_bins = num_bins
        self.decoder = DepthFormerDecoderV2(
            [self.encoder.channels[i] for i in TAPS], hidden_dim, num_heads, img_size,
            attn_drop_prob=attn_drop_prob, drop_prob=drop_prob, range_map=True)
        self.conv_out = Conv1x1(128, num_bins, bias=True)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        (range_map, widths), attn = self.decoder(self.features(x), generator)
        out = self.conv_out(range_map).float().softmax(dim=-1)
        n = self.num_bins
        widths = widths[:, :n] if widths.shape[1] >= n else F.pad(
            widths, (0, n - widths.shape[1]), value=1e-3)
        widths = F.pad((self.max_depth - self.min_depth) * widths, (1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return (out * centers[:, None, None, :]).sum(dim=-1, keepdim=True), edges, attn

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``num_bins`` 100 unless given)."""
        kwargs = dict(hidden_dim=opt["hidden_dim"], num_heads=opt["num_heads"],
                      img_size=tuple(opt["img_size"]), num_bins=opt.get("num_bins", 100),
                      min_depth=min_depth, max_depth=max_depth,
                      attn_drop_prob=opt.get("attn_drop_prob", 0.1),
                      drop_prob=opt.get("drop_prob", 0.1))
        kwargs.update(overrides)
        return cls(**kwargs)


class DepthFormerDecoderV4(nn.Module):
    """The cls-token decoder (``versions.py:241-323``) over the five taps'
    maps of ``enc_channels``: at each scale from 1/32 to 1/2 a residual
    ConvBN block (of the upsampled, GELU'd concat below 1/32), then the
    cls token's attention over the scale's 1x1-conv keys (the logits in the
    activation dtype times hd^-0.5, the softmax in f32), its update, and
    the values gated by sigmoid(FF(cls)) through a 1x1 ConvBN added to the
    map. The FF is ``cls_to_weight_layers.{i}``: Linear to 2d (the JAX
    build leaves ``feedforward_dim`` unset), dropout, GELU, Linear (slots 1
    and 2 keep the reference's index 3). Returns (the f32 hard-sigmoid map at 1/2
    scale, the (B, heads, N) f32 weights from 1/32 to 1/2)."""

    def __init__(self, enc_channels: Sequence[int], hidden_dim: int, num_heads: int,
                 drop_prob: float = 0.1):
        super().__init__()
        d = hidden_dim
        if d % num_heads:
            raise ValueError(f"{d} channels do not split into {num_heads} heads")
        ff = 2 * d
        self.num_heads = num_heads
        self.depth_cls = nn.Parameter(torch.zeros(1, d))
        self.q_projections = nn.ModuleList(Linear(d, d) for _ in range(5))
        self.k_projections = nn.ModuleList(Conv1x1(d, d, bias=True) for _ in range(5))
        self.v_projections = nn.ModuleList(Conv1x1(d, d, bias=True) for _ in range(5))
        self.post_conv_layers = nn.ModuleList(
            ResConvBNBlock(c + (d if i < 4 else 0), d, 3) for i, c in enumerate(enc_channels))
        self.post_cls_layers = nn.ModuleList(Linear(d, d) for _ in range(5))
        self.post_cls_ln = nn.ModuleList(LayerNorm(d) for _ in range(5))
        self.cls_to_weight_layers = nn.ModuleList(
            nn.Sequential(Linear(d, ff), nn.Identity(), nn.Identity(), Linear(ff, d))
            for _ in range(5))
        self.post_weight_layers = nn.ModuleList(ConvBN(d, d, 1, use_residual=False)
                                                for _ in range(5))
        # slot 0 is the GELU, applied in forward
        self.final_block = nn.Sequential(nn.Identity(), ResConvBNBlock(d, d, 3),
                                         Conv1x1(d, 1, bias=True))
        self.drop = Dropout(drop_prob)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        self.depth_cls.data.normal_(0.0, math.sqrt(1.0 / self.depth_cls.shape[1]),
                                    generator=generator)

    def _scale_step(self, i: int, c: torch.Tensor, cls: torch.Tensor, generator):
        b, h, w, d = c.shape
        nh = self.num_heads
        q = self.q_projections[i](cls).reshape(b, nh, d // nh)
        k = self.k_projections[i](c).reshape(b, h * w, nh, d // nh)
        v = self.v_projections[i](c)
        pre = torch.einsum("bnhd,bhd->bhn", k, q) * torch.tensor(math.sqrt(1.0 / (d // nh)),
                                                                 dtype=c.dtype)
        attn = pre.float().softmax(dim=-1)
        up = torch.einsum("bhn,bnhd->bhd", attn.to(c.dtype), v.reshape(b, h * w, nh, d // nh))
        cls = self.post_cls_ln[i](cls + self.post_cls_layers[i](up.reshape(b, 1, d)))
        fc1, _, _, fc2 = self.cls_to_weight_layers[i]
        gate = fc2(gelu(self.drop(fc1(cls), generator)))
        gated = self.post_weight_layers[i](v * torch.sigmoid(gate.to(v.dtype))[:, None])
        return c + gated, cls, attn

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        x0, x1, x2, x3, x4 = features
        b, d = x0.shape[0], self.depth_cls.shape[1]
        cls = self.depth_cls[None].expand(b, 1, d).to(x0.dtype) * torch.tensor(
            math.sqrt(1.0 / d), dtype=x0.dtype)
        v, cls, attn = self._scale_step(4, self.post_conv_layers[4](x4), cls, generator)
        attns = [attn]
        for i, skip in ((3, x3), (2, x2), (1, x1), (0, x0)):
            c = self.post_conv_layers[i](upscale_concat_act(skip, v, 2))
            v, cls, attn = self._scale_step(i, c, cls, generator)
            attns.append(attn)
        _, final_res, final_out = self.final_block
        y = final_out(final_res(gelu(v))).float()
        return F.relu6(y + 3.0) / 6.0, tuple(attns)


class DepthformerV4(EfficientNetDepthModel):
    """v4 (``versions.py:326-360``): any input size (the JAX build reads
    ``img_size`` from the config and uses it nowhere; its
    ``attn_drop_prob`` reaches no layer either). ``forward`` returns
    ``(depth, (5 weights))``: the f32 (B, H/2, W/2, 1) depth and the cls
    token's (B, heads, N) f32 attention weights at each scale."""

    def __init__(self, hidden_dim: int, num_heads: int, min_depth: float = 0.001,
                 max_depth: float = 80.0, drop_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32, encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, False, dtype, encoder_kwargs)
        self.decoder = DepthFormerDecoderV4([self.encoder.channels[i] for i in TAPS],
                                            hidden_dim, num_heads, drop_prob=drop_prob)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        out, attn = self.decoder(self.features(x), generator)
        return self.rescale(out), attn

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """As the JAX build (``hidden_dim``, ``num_heads``; dropout 0.1)."""
        kwargs = dict(hidden_dim=opt["hidden_dim"], num_heads=opt["num_heads"],
                      min_depth=min_depth, max_depth=max_depth,
                      drop_prob=opt.get("drop_prob", 0.1))
        kwargs.update(overrides)
        return cls(**kwargs)
