"""ODA2 ordered-reduction models ``oda2_red_order_reg`` and
``oda2_red_order_cls`` (``mde_tpu/models/oda2/red_order_reg.py``).

Ordered-depth iterative refinement with reduction attention (K/V from
r x r block means). Each of ``num_repeats`` rounds: a conv head gives a
logit; the reg head quantises log-sigmoid(logit) / 10 + 1 into ``num_emb``
indices (no gradient) and looks up a fixed sinusoidal table; the cls head
gives ``num_emb`` logits, whose f32 softmax mixes learnable depth bins for
the map and a learnable sinusoidal table for the features. An
``OrderedReductionBlock`` adds the embedding (an FF and a LayerNorm whose
scale starts at 0.1) and runs 2 x (reduction SA + DWConv-GLU FF, kernel K3
or, fused, K4). The neck: per-scale ConvBN chains to (2d, d, d/2, d/4)
channels, upsampled to 1/4 scale, concatenated, Linear + LayerNorm.

Parameter names follow the reference torch state dict, the names
``mde_tpu.core.family_converters.convert_oda2_red_order_decoder``
(``:581-596`` the neck, ``:745-759`` a block, ``:762-793`` the head)
converts from: ``enc_conv{s}.{j}``, ``dec_linear``, ``dec_norm``,
``reducer.conv_layers.{i}.{0,1,2}``, ``reducer.attn_layers.{i}`` with
``de_ff.0``, ``de_ff.3``, ``de_norm``, ``sa1``, ``ff1``, ``sa2``, ``ff2``,
``norm2``; the cls head's ``reducer.depth_bins`` (1, E, 1, 1) and
``reducer.depth_embedding``. The reg head's fixed table is a buffer the
converter skips (``:779``), so it is not in the state dict.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.conv import Conv1x1, ConvBN
from ...ops.drop import Dropout
from ...ops.init import depth_bins_init
from ...ops.mlp import PreNormDWConvFF
from ...ops.reduction import PreNormOrderedReductionSA, sinusoidal_depth_embedding
from ...ops.resize import upsample2d
from ...ops.tnn import LayerNorm, Linear, gelu
from .base import SwinDepthModel

Attns = Tuple[None, ...]


class OrderedReductionBlock(nn.Module):
    """Depth embedding through Linear -> dropout -> GELU -> Linear ->
    LayerNorm (scale 0.1), added to x; then 2 x (reduction SA at shift 0 +
    DWConv-GLU FF) and a LayerNorm (``red_order_reg.py:43-90``). Returns
    (x, the two SAs' weights: None)."""

    def __init__(self, dim: int, num_heads: int, reduction_ratio: int = 8,
                 feedforward_dims: Optional[int] = None, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        # slot 2 (the GELU, applied in forward) only keeps the reference's index 3
        self.de_ff = nn.Sequential(Linear(dim, 4 * dim), Dropout(drop_prob), nn.Identity(),
                                   Linear(4 * dim, dim, bias=False))
        self.de_norm = LayerNorm(dim, scale_init=0.1)
        sa = dict(num_heads=num_heads, reduction_ratio=reduction_ratio,
                  attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)
        ff = dict(feedforward_dims=feedforward_dims, bn_eps=bn_eps, drop_prob=drop_prob,
                  bn_momentum=bn_momentum)
        self.sa1 = PreNormOrderedReductionSA(dim, **sa)
        self.ff1 = PreNormDWConvFF(dim, **ff)
        self.sa2 = PreNormOrderedReductionSA(dim, **sa)
        self.ff2 = PreNormDWConvFF(dim, **ff)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, de: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Attns]:
        lin0, drop, _, lin3 = self.de_ff
        y = self.de_norm(lin3(gelu(drop(lin0(de), generator))))
        x = x + y
        x = self.ff1(self.sa1(x, y, generator), generator)
        x = self.ff2(self.sa2(x, y, generator), generator)
        return self.norm2(x), (None, None)


class RedNeck(nn.Module):
    """The reduction decoders' neck (JAX ``_RedNeck``, ``red_order_reg.py:93-130``;
    with ``convs=3`` the gen-1 neck, ``red_order_swin.py:80-118``): per scale
    a chain of ConvBNs, in -> in -> (2d, d, d/2, d/4 at 1/4 ... 1/32), or
    in -> in -> d/4 -> d/4 with three, upsampled to 1/4 scale,
    concatenated fine to coarse, then bias-free Linear to d and LayerNorm
    (:meth:`neck`; :meth:`neck_concat` also returns the concat before the
    Linear, JAX's ``return_concat``). A decoder subclasses it, so that the
    neck's modules sit at the decoder's top level under the reference's
    names."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int, convs: int = 2,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        if convs not in (2, 3) or dec_dim % 4:
            raise ValueError(f"a neck of {convs} convs a scale at dec_dim {dec_dim}")
        d = dec_dim
        outs = ({"4": 2 * d, "8": d, "16": d // 2, "32": d // 4} if convs == 2
                else dict.fromkeys(("4", "8", "16", "32"), d // 4))
        for (s, c) in zip(("4", "8", "16", "32"), enc_dims):
            chans = (c, c, outs[s]) if convs == 2 else (c, c, d // 4, d // 4)
            setattr(self, f"enc_conv{s}", nn.Sequential(*(
                ConvBN(a, b, 3, bn_eps, bn_momentum=bn_momentum)
                for a, b in zip(chans, chans[1:]))))
        self.dec_linear = Linear(sum(outs.values()), d, bias=False)
        self.dec_norm = LayerNorm(d)

    def neck_concat(self, features: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        ys = [upsample2d(getattr(self, f"enc_conv{s}")(f), k)
              for s, f, k in zip(("4", "8", "16", "32"), features, (1, 2, 4, 8))]
        cat = torch.cat(ys, dim=-1)
        return self.dec_norm(self.dec_linear(cat)), cat

    def neck(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.neck_concat(features)[0]


def _logit_to_indices(logit: torch.Tensor, num_emb: int) -> torch.Tensor:
    """Log-sigmoid quantisation (``red_order_reg.py:154-159``): the detached
    one-channel logit -> (B, H, W) int32 indices
    floor(clip(log_sigmoid(logit) / 10 + 1, 0, 1) * E - 1e-3), clipped to
    [0, E)."""
    ls = F.logsigmoid(logit.detach())
    idx = torch.floor(torch.clamp(ls / 10.0 + 1.0, 0.0, 1.0) * num_emb - 1e-3)
    return idx.clamp(0, num_emb - 1).to(torch.int32)[..., 0]


def conv_head(in_dims: int, out_ch: int, bias: bool, bn_momentum: float,
              bn_eps: float) -> nn.Sequential:
    """ConvBN -> ConvBN to in_dims / 4 -> 1x1 conv to ``out_ch`` logits."""
    ck = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
    return nn.Sequential(ConvBN(in_dims, in_dims // 4, 3, **ck),
                         ConvBN(in_dims // 4, in_dims // 4, 3, **ck),
                         Conv1x1(in_dims // 4, out_ch, bias=bias))


class IndexedTableHead(nn.Module):
    """The loop that the reg head and gen-1's head share: per repeat the
    conv head's sigmoid map, its log-sigmoid indices into the subclass's
    ``depth_embedding`` (times ``table_scale`` at lookup), then the block
    that ``make_block`` builds; the last conv head's sigmoid map. Returns
    (the ``num_repeats + 1`` maps, the blocks' weights)."""

    def __init__(self, in_dims: int, num_repeats: int, num_emb: int,
                 make_block: Callable[[], nn.Module], table_scale: float,
                 bn_momentum: float, bn_eps: float):
        super().__init__()
        self.num_emb = num_emb
        self.table_scale = table_scale
        self.conv_layers = nn.ModuleList(conv_head(in_dims, 1, False, bn_momentum, bn_eps)
                                         for _ in range(num_repeats + 1))
        self.attn_layers = nn.ModuleList(make_block() for _ in range(num_repeats))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], Attns]:
        outs, attns = [], ()
        for conv, attn in zip(self.conv_layers, self.attn_layers):
            logit = conv(x)
            outs.append(torch.sigmoid(logit))
            de = self.depth_embedding[_logit_to_indices(logit, self.num_emb).long()]
            x, weights = attn(x, (de * self.table_scale).to(x.dtype), generator)
            attns += weights
        outs.append(torch.sigmoid(self.conv_layers[-1](x)))
        return tuple(outs), attns


class OrderedReductionRegHead(IndexedTableHead):
    """The reg head (``red_order_reg.py:133-185``): the fixed base-2000
    table is a buffer, looked up unscaled; the blocks' weights are
    2 * ``num_repeats`` Nones."""

    def __init__(self, in_dims: int, num_heads: int, num_repeats: int, num_emb: int = 128,
                 reduction_ratio: int = 8, attn_drop_prob: float = 0.0,
                 drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__(
            in_dims, num_repeats, num_emb,
            lambda: OrderedReductionBlock(in_dims, num_heads, reduction_ratio,
                                          attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
                                          bn_momentum=bn_momentum, bn_eps=bn_eps),
            1.0, bn_momentum, bn_eps)
        self.register_buffer("depth_embedding",
                             sinusoidal_depth_embedding(num_emb, in_dims, 2000.0),
                             persistent=False)


class OrderedReductionClsHead(nn.Module):
    """The cls head (``red_order_reg.py:188-257``): per repeat ``num_emb``
    logits whose f32 softmax(logit / T) weighs the learnable depth bins
    (the map) and the learnable base-1000 table (the embedding, f32, then
    cast), then the block; the last conv head's map."""

    def __init__(self, in_dims: int, num_heads: int, num_repeats: int, num_emb: int = 128,
                 reduction_ratio: int = 8, temperature: float = 1.0,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.temperature = temperature
        self.conv_layers = nn.ModuleList(conv_head(in_dims, num_emb, True, bn_momentum, bn_eps)
                                         for _ in range(num_repeats + 1))
        self.attn_layers = nn.ModuleList(
            OrderedReductionBlock(in_dims, num_heads, reduction_ratio,
                                  attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
                                  bn_momentum=bn_momentum, bn_eps=bn_eps)
            for _ in range(num_repeats))
        # the reference's NCHW broadcast shape (1, E, 1, 1)
        self.depth_bins = nn.Parameter(depth_bins_init(num_emb).reshape(1, num_emb, 1, 1))
        self.depth_embedding = nn.Parameter(sinusoidal_depth_embedding(num_emb, in_dims,
                                                                       1000.0))

    def _decode(self, logit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        prob = (logit.float() / self.temperature).softmax(dim=-1)
        return prob, (prob * self.depth_bins.reshape(-1)).sum(dim=-1, keepdim=True)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], Attns]:
        outs, attns = [], ()
        for conv, attn in zip(self.conv_layers, self.attn_layers):
            prob, out = self._decode(conv(x))
            outs.append(out)
            de = torch.einsum("bhwc,cd->bhwd", prob, self.depth_embedding.float())
            x, weights = attn(x, de.to(x.dtype), generator)
            attns += weights
        outs.append(self._decode(self.conv_layers[-1](x))[1])
        return tuple(outs), attns


class OrderedReductionDecoder(RedNeck):
    """The neck and the reg or cls head (``red_order_reg.py:260-294``)."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int, num_heads: int,
                 num_repeats: int, num_emb: int = 128, reduction_ratio: int = 8,
                 temperature: float = 1.0, cls_head: bool = False,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__(enc_dims, dec_dim, 2, bn_momentum, bn_eps)
        kw = dict(num_emb=num_emb, reduction_ratio=reduction_ratio,
                  attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
                  bn_momentum=bn_momentum, bn_eps=bn_eps)
        self.reducer = (OrderedReductionClsHead(dec_dim, num_heads, num_repeats,
                                                temperature=temperature, **kw) if cls_head
                        else OrderedReductionRegHead(dec_dim, num_heads, num_repeats, **kw))

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], Attns]:
        return self.reducer(self.neck(features), generator)


class ODA2OrderedRegModel(SwinDepthModel):
    """Swin encoder + ordered reduction decoder, reg or (``cls_head``) cls
    (``red_order_reg.py:297-365``). ``forward`` takes (B, H, W, 3) f32
    images and returns ``(out, outs, attns)``: the last map, all
    ``num_repeats + 1`` maps (f32, times ``max_depth``) and the SAs'
    weights (None). Activations run in ``dtype``. In training BatchNorm
    takes batch statistics and stochastic depth and dropout draw from the
    ``generator`` given to ``forward``. ``use_checkpoint`` (on by default,
    as in JAX) recomputes the encoder's blocks only: JAX hands it to the
    encoder and nowhere else."""

    def __init__(self, dec_dim: int, min_depth: float, max_depth: float, num_heads: int,
                 num_repeats: int, num_emb: int, reduction_ratio: int = 8,
                 cls_head: bool = False, encoder_type: str = "large", drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0, bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_checkpoint: bool = True, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.decoder = OrderedReductionDecoder(
            self.encoder.num_features, dec_dim, num_heads, num_repeats, num_emb,
            reduction_ratio, cls_head=cls_head, attn_drop_prob=attn_drop_prob,
            drop_prob=drop_prob, bn_momentum=bn_momentum, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], Attns]:
        outs, attns = self.decoder(self.features(x, generator), generator)
        outs = tuple(o.float() * self.max_depth for o in outs)
        return outs[-1], outs, attns

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, cls_head: bool = False,
              **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``red_order_reg.py:351-365``); ``overrides``
        (``use_checkpoint``, ``path_drop_prob``, ``dtype``, ...) go to the
        constructor."""
        kwargs = dict(
            dec_dim=opt["dec_dim"], num_heads=opt["num_heads"],
            num_repeats=opt["num_repeats"], num_emb=opt["num_emb"],
            reduction_ratio=opt.get("reduction_ratio", 8), min_depth=min_depth,
            max_depth=max_depth, cls_head=cls_head,
            encoder_type=opt.get("encoder_type", "large"),
            drop_prob=opt.get("drop_prob", 0.0), attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
