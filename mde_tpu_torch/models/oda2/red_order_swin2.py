"""The flagship ``oda2_red_order_swin2``
(``mde_tpu/models/oda2/red_order_swin2.py``), in eval and training mode.

Ordered-depth iterative refinement: the head runs ``num_repeats`` rounds of
{conv head -> one-channel logit -> sigmoid depth map; quantise the logit
into ``num_emb`` indices; an ordered shifted-window attention block whose
logits are biased by the pairwise differences of those indices}. All
``num_repeats + 1`` maps are returned; inference uses the last.

Parameter names follow the reference torch state dict (``encoder.*``,
``decoder.enc_conv{s}.{j}``, ``decoder.enc_fuse``,
``decoder.reducer.conv_layers.{i}.{j}``, ``decoder.reducer.attn_layers.{i}``),
so ``state_dict()`` goes straight through
``mde_tpu.core.checkpoint.convert_oda2_red_order_swin2``. The head is the
unrolled layout only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.conv import Conv1x1, ConvBN
from ...ops.mlp import PreNormDWConvFF
from ...ops.ordered_attention import PreNormOrderedSwinSA
from ...ops.remat import checkpoint
from ...ops.resize import upsample2d
from ...ops.tnn import LayerNorm, Linear
from .base import SwinDepthModel, Upsample2d

NECK_TYPES = ("red", "fpn", "segformer", "red33", "red33r", "red33res")


class OrderedSwinBlock(nn.Module):
    """[ordered SA (shift 0) + DWConv-GLU FF] x [ordered SA (shift r/2) +
    DWConv-GLU FF] + Linear + LN. ``attn_drop_prob`` and ``drop_prob`` go
    to both SAs, ``drop_prob`` and ``bn_momentum`` to both FFs
    (``mde_tpu/models/oda2/red_order_swin2.py:50-71``); dropout draws from
    the ``generator`` given to ``forward``. ``return_weights``: ``forward``
    returns ``(x, (weights of sa1, weights of sa2))``. ``tp_axis`` goes to
    both FFs (``ops/mlp.PreNormDWConvFF``)."""

    def __init__(self, dim: int, num_heads: int, num_emb: int, window_size: int = 8,
                 feedforward_dims: Optional[int] = None, bias_type: str = "depth",
                 bias_init: str = "linear", bn_eps: float = 1e-5,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, return_weights: bool = False,
                 tp_axis: Optional[str] = None):
        super().__init__()
        self.return_weights = return_weights
        sa = dict(num_heads=num_heads, num_emb=num_emb, window_size=window_size,
                  bias_type=bias_type, bias_init=bias_init, attn_drop_prob=attn_drop_prob,
                  drop_prob=drop_prob, return_weights=return_weights)
        ff = dict(feedforward_dims=feedforward_dims, bn_eps=bn_eps, drop_prob=drop_prob,
                  bn_momentum=bn_momentum, tp_axis=tp_axis)
        self.sa1 = PreNormOrderedSwinSA(dim, shift_size=0, **sa)
        self.ff1 = PreNormDWConvFF(dim, **ff)
        self.sa2 = PreNormOrderedSwinSA(dim, shift_size=window_size // 2, **sa)
        self.ff2 = PreNormDWConvFF(dim, **ff)
        self.linear = Linear(dim, dim, bias=False)
        self.norm = LayerNorm(dim)

    def drops(self) -> bool:
        """Whether a call in the current mode draws element-wise dropout."""
        return self.training and (self.sa1.attn_drop.rate > 0 or self.sa1.drop.rate > 0)

    def forward(self, x: torch.Tensor, indices: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        weights = []
        for sa, ff in ((self.sa1, self.ff1), (self.sa2, self.ff2)):
            x = sa(x, indices, generator)
            if self.return_weights:
                x, w = x
                weights.append(w)
            x = ff(x, generator)
        x = self.norm(self.linear(x))
        return (x, tuple(weights)) if self.return_weights else x


def _quantize_logit(logit: torch.Tensor, num_emb: int) -> torch.Tensor:
    """sigmoid(logit) -> (B, H, W) int32 index map in [0, num_emb), no grad
    (the logit is detached, as ``stop_gradient`` does at :96).
    floor(p*E - 1e-3) is -1 for p < 7.8e-6; it is clamped to 0 (the
    reference wraps it to the last row instead)."""
    p = torch.sigmoid(logit.detach())
    idx = torch.floor(p * num_emb - 1e-3)
    return idx.clamp(0, num_emb - 1).to(torch.int32)[..., 0]


def _conv_head(in_dims: int, upsample: bool, bn_eps: float,
               bn_momentum: float) -> nn.Sequential:
    """[upsample x2 ->] ConvBN -> ConvBN -> 1x1 conv to one channel (logit)."""
    layers = [Upsample2d(2)] if upsample else []
    ck = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
    layers += [ConvBN(in_dims, in_dims // 4, 3, **ck),
               ConvBN(in_dims // 4, in_dims // 4, 3, **ck),
               Conv1x1(in_dims // 4, 1, bias=False)]
    return nn.Sequential(*layers)


class OrderedSwinRegHead(nn.Module):
    """Iterative ordered refinement head, unrolled: ``conv_layers.{i}`` and
    ``attn_layers.{i}`` per repeat, plus the final conv head.
    ``use_checkpoint`` recomputes each repeat's ``OrderedSwinBlock`` in the
    backward pass under the recompute policy (``ops/remat.py``;
    ``mde_tpu/models/oda2/red_order_swin2.py:237-242``), its dropout masks
    drawn again from the same generator state. ``return_weights``:
    ``forward`` returns ``(maps, weights)``, the two ordered SAs' f32
    weights of each repeat in order; the blocks are then not recomputed
    (a checkpointed block returns one tensor), which changes the memory a
    training step holds and none of its numbers."""

    def __init__(self, in_dims: int, num_heads: int, num_repeats: int, num_emb: int = 128,
                 window_size: int = 8, feedforward_dims: Optional[int] = None,
                 output_scale: int = 4, bias_type: str = "depth", bias_init: str = "linear",
                 bn_eps: float = 1e-5, use_checkpoint: bool = False,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, return_weights: bool = False,
                 tp_axis: Optional[str] = None):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.return_weights = return_weights
        if output_scale not in (2, 4):
            raise ValueError(f"output_scale must be 2 or 4, got {output_scale}")
        self.num_emb = num_emb
        self.conv_layers = nn.ModuleList(
            _conv_head(in_dims, i == num_repeats and output_scale == 2, bn_eps, bn_momentum)
            for i in range(num_repeats + 1))
        self.attn_layers = nn.ModuleList(
            OrderedSwinBlock(in_dims, num_heads, num_emb, window_size, feedforward_dims,
                             bias_type, bias_init, bn_eps, attn_drop_prob, drop_prob,
                             bn_momentum, return_weights, tp_axis)
            for _ in range(num_repeats))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        outs, weights = [], ()
        for conv, attn in zip(self.conv_layers, self.attn_layers):
            logit = conv(x)
            outs.append(torch.sigmoid(logit))
            idx = _quantize_logit(logit, self.num_emb)
            if self.return_weights:
                x, aws = attn(x, idx, generator)
                weights += aws
            elif self.use_checkpoint and torch.is_grad_enabled():
                x = checkpoint(attn, x, idx, generator=generator if attn.drops() else None)
            else:
                x = attn(x, idx, generator)
        outs.append(torch.sigmoid(self.conv_layers[-1](x)))
        return (tuple(outs), weights) if self.return_weights else tuple(outs)


class OrderedSwin2RegDecoder(nn.Module):
    """Neck (red / fpn / segformer / red33 / red33r / red33res) + ordered
    head, over encoder features of ``enc_dims`` channels at strides
    4/8/16/32. ``bn_momentum`` reaches every BatchNorm, the dropout rates
    every ordered block (``mde_tpu/models/oda2/red_order_swin2.py:284-392``).
    ``return_weights`` as the head's; ``tp_axis`` goes to every FF."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int = 512, num_heads: int = 8,
                 num_repeats: int = 3, num_emb: int = 128, window_size: int = 8,
                 output_scale: int = 4, bias_type: str = "depth", bias_init: str = "linear",
                 neck_type: str = "red", bn_eps: float = 1e-5, use_checkpoint: bool = False,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, return_weights: bool = False,
                 tp_axis: Optional[str] = None):
        super().__init__()
        if neck_type not in NECK_TYPES:
            raise ValueError(f"Unsupported neck type {neck_type}.")
        if dec_dim % 4:
            raise ValueError(f"dec_dim {dec_dim} is not a multiple of 4")
        self.neck_type = neck_type
        c4, c8, c16, c32 = enc_dims
        d = dec_dim

        ck = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)

        def chain(chans):
            return nn.Sequential(*(ConvBN(a, b, 3, **ck) for a, b in zip(chans, chans[1:])))

        dims = {"32": c32, "16": c16, "8": c8, "4": c4}
        if neck_type == "red":
            for s, c in dims.items():
                setattr(self, f"enc_conv{s}", chain((c, c, d // 4, d // 4)))
        elif neck_type == "fpn":
            self.enc_conv32 = chain((c32, d, d))
            for s in ("16", "8", "4"):
                setattr(self, f"enc_conv{s}", chain((dims[s] + d, d, d)))
        elif neck_type == "segformer":
            for s, c in dims.items():
                setattr(self, f"enc_conv{s}", nn.Sequential(Conv1x1(c, d, bias=True)))
            self.enc_fuse = ConvBN(4 * d, d, 1, **ck)
        else:
            widths = {s: (d if neck_type != "red33r" else min(c, d)) for s, c in dims.items()}
            for s, c in dims.items():
                setattr(self, f"enc_conv{s}", chain((c, widths[s], widths[s])))
                if neck_type == "red33res":
                    setattr(self, f"enc_res{s}", ConvBN(c, d, 1, **ck))
            self.enc_fuse = ConvBN(sum(widths.values()), d, 1, **ck)
        self.dec_linear = Linear(d, d, bias=False)
        self.dec_norm = LayerNorm(d)
        self.reducer = OrderedSwinRegHead(d, num_heads, num_repeats, num_emb, window_size,
                                          output_scale=output_scale, bias_type=bias_type,
                                          bias_init=bias_init, bn_eps=bn_eps,
                                          use_checkpoint=use_checkpoint,
                                          attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
                                          bn_momentum=bn_momentum,
                                          return_weights=return_weights, tp_axis=tp_axis)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        e4, e8, e16, e32 = features
        feats = (("32", e32, 8), ("16", e16, 4), ("8", e8, 2), ("4", e4, 1))
        if self.neck_type == "red":
            ys = [upsample2d(getattr(self, f"enc_conv{s}")(f), k) for s, f, k in feats]
            dec = torch.cat(ys[::-1], dim=-1)
        elif self.neck_type == "fpn":
            y = upsample2d(self.enc_conv32(e32), 2)
            y = upsample2d(self.enc_conv16(torch.cat([e16, y], dim=-1)), 2)
            y = upsample2d(self.enc_conv8(torch.cat([e8, y], dim=-1)), 2)
            dec = self.enc_conv4(torch.cat([e4, y], dim=-1))
        else:
            ys = []
            for s, f, k in feats:
                y = getattr(self, f"enc_conv{s}")(f)
                if self.neck_type == "red33res":
                    y = y + getattr(self, f"enc_res{s}")(f)
                ys.append(upsample2d(y, k))
            dec = self.enc_fuse(torch.cat(ys[::-1], dim=-1))
        return self.reducer(self.dec_norm(self.dec_linear(dec)), generator)


class ODA2OrderedSwin2RegModel(SwinDepthModel):
    """The flagship: Swin encoder + ordered decoder. ``forward`` takes
    (B, H, W, 3) f32 images and returns ``(out, outs)``: the last depth map
    and all ``num_repeats + 1`` maps, f32, scaled by ``max_depth``.
    Activations run in ``dtype`` (parameters stay f32). In training mode
    BatchNorm takes batch statistics, and the encoder's stochastic depth and
    the decoder's dropout (``drop_prob``, ``attn_drop_prob``) draw from the
    ``generator`` given to ``forward``. ``bn_momentum`` reaches every
    decoder BatchNorm. ``use_checkpoint`` recomputes each Swin block and
    each head repeat's ordered block in the backward pass; it is on by
    default, as in the JAX model, so that one config trains the same way on
    both. ``return_weights``: ``forward`` returns ``(out, outs,
    attn_weights)``, the f32 (B*nW, heads, N, N) weights of the two ordered
    SAs of each repeat (``mde_tpu/models/oda2/red_order_swin2.py:425,471``),
    the SAs on JAX's einsum path in place of K2. ``tp_axis`` (``"model"``)
    splits every FF's hidden channels over the model axis of a mesh
    (``ops/mlp.PreNormDWConvFF``, ``parallel.mesh``)."""

    def __init__(self, dec_dim: int, min_depth: float, max_depth: float, num_heads: int,
                 num_repeats: int, num_emb: int, window_size: int = 8,
                 encoder_type: str = "large", output_scale: int = 4,
                 bias_type: str = "depth", bias_init: str = "linear", neck_type: str = "red",
                 bn_eps: float = 1e-5, path_drop_prob: float = 0.2,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None, use_checkpoint: bool = True,
                 drop_prob: float = 0.0, attn_drop_prob: float = 0.0,
                 bn_momentum: float = 0.1, return_weights: bool = False,
                 tp_axis: Optional[str] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.return_weights = return_weights
        self.decoder = OrderedSwin2RegDecoder(
            self.encoder.num_features, dec_dim, num_heads, num_repeats, num_emb, window_size,
            output_scale, bias_type, bias_init, neck_type, bn_eps, use_checkpoint,
            attn_drop_prob, drop_prob, bn_momentum, return_weights, tp_axis)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> tuple:
        outs = self.decoder(self.features(x, generator), generator)
        if self.return_weights:
            outs, weights = outs
        outs = tuple(o.float() * self.max_depth for o in outs)
        return (outs[-1], outs, weights) if self.return_weights else (outs[-1], outs)

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section, with the JAX
        package's defaults; ``overrides`` (``use_checkpoint``,
        ``path_drop_prob``, ``dtype``, ...) go to the constructor."""
        kwargs = dict(
            dec_dim=opt["dec_dim"], num_heads=opt["num_heads"],
            num_repeats=opt["num_repeats"], num_emb=opt["num_emb"],
            window_size=opt.get("window_size", 8), min_depth=min_depth,
            max_depth=max_depth, encoder_type=opt["encoder_type"],
            output_scale=opt.get("output_scale", 4),
            drop_prob=opt.get("drop_prob", 0.0),
            attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bias_type=opt.get("bias_type", "depth"),
            bias_init=opt.get("bias_init", "linear"),
            neck_type=opt.get("neck_type", "red"),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5),
            tp_axis=opt.get("tp_axis"))
        kwargs.update(overrides)
        return cls(**kwargs)
