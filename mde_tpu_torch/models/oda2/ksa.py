"""ODA2 ``oda2_ksa_reg``, the Kernel-window Self-Attention decoder pyramid
(``mde_tpu/models/oda2/ksa.py``), in eval and training mode.

A Swin-like decoder runs coarse to fine over a Swin encoder's features: the
coarsest stage is plain W-MSA / SW-MSA Swin blocks, each finer stage's
blocks prepend a ``KernelWindowAttention`` (per window, a channel cross
attention between the decoder tokens and that scale's encoder window, kernel
K5) to their W-MSA (kernel K1), with pre-norm residuals and two MLPs.
``PatchUnMerging`` upsamples between stages. Inputs: a Pyramid Pooling
Module at 1/32 and a ConvBN lateral per finer scale; head: ConvBN, a biased
3x3 VALID conv (the map shrinks by 2 px) and a sigmoid.

Parameter names follow the reference torch state dict (``decoder.ppm32``,
``decoder.enc_conv{16,8,4}``, ``decoder.layers.{i}.blocks.{j}.*``,
``decoder.layers.{i}.upsample.expansion``, ``decoder.dec_conv4``,
``decoder.out_conv``), the names
``mde_tpu.core.family_converters.convert_oda2_ksa_decoder`` converts from.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.attention import WindowAttention
from ...ops.conv import ConvBN, ValidConv
from ...ops.drop import Dropout, DropPath
from ...ops.kernels.channel_attention import channel_attention
from ...ops.mlp import SwinMLP
from ...ops.pad import pad_to_multiple
from ...ops.ppm import PyramidPoolingModule
from ...ops.tnn import LayerNorm, Linear
from ...ops.window import (cyclic_shift, shifted_window_attn_mask, window_partition,
                           window_reverse)
from ..swin import SwinBlock
from .base import SwinDepthModel


class KernelWindowAttention(nn.Module):
    """Per window (``ksa.py:41-96``): q from the decoder tokens, k and v
    from the encoder window (one fused ``kv`` projection), attention over
    head-channel pairs at scale sqrt(1/N) (kernel K5), then ``proj`` and
    its dropout (``drop_prob``). In training with ``attn_drop_prob`` > 0
    the probabilities go through dropout on JAX's einsum path (``:79-91``),
    where the JAX module leaves its kernel too."""

    def __init__(self, dim: int, enc_dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        if dim % num_heads or enc_dim % num_heads:
            raise ValueError(f"{dim} and {enc_dim} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(enc_dim, 2 * enc_dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.attn_drop = Dropout(attn_drop_prob)
        self.proj_drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, kv = self.q(x), self.kv(enc)
        scale = math.sqrt(1.0 / x.shape[1])
        if self.training and self.attn_drop.rate > 0:
            out = self._dropout_attention(q, kv, scale, generator)
        else:
            out = channel_attention(q, kv, self.num_heads, scale)
        return self.proj_drop(self.proj(out), generator)

    def _dropout_attention(self, q, kv, scale, generator) -> torch.Tensor:
        """The JAX module's einsum path: the (head dim x encoder head dim)
        logits in the activation dtype times the scale, softmax in f32,
        cast back, dropout, then the mix of v's channels."""
        bw, n, c = q.shape
        nh = self.num_heads
        k, v = (t.reshape(bw, n, nh, -1) for t in kv.chunk(2, dim=-1))
        attn = torch.einsum("bnhd,bnhe->bhde", q.reshape(bw, n, nh, c // nh), k)
        attn = attn * torch.tensor(scale, dtype=attn.dtype)
        attn = self.attn_drop(attn.float().softmax(dim=-1).to(q.dtype), generator)
        return torch.einsum("bhde,bnhe->bnhd", attn, v).reshape(bw, n, c)


class KSABlock(nn.Module):
    """KSA transformer block, the reference's dataflow verbatim
    (``ksa.py:99-185``): kernel attention on the (shifted) windows, then on
    the shifted path a roll of the windowed token tensor on its (token,
    channel) dims by +shift (:151) instead of a spatial unshift; FFN1 on the
    map; a second cyclic shift of the whole map (:164); W-MSA / SW-MSA
    (kernel K1) and the same roll (:175); FFN2. Each of the four residual
    branches draws its own stochastic-depth mask from the generator, per
    window for the two attentions and per image for the MLPs.
    ``attn_drop_prob`` and ``drop_prob`` reach the kernel attention, the
    W-MSA and both MLPs, as in JAX."""

    def __init__(self, dim: int, enc_dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 path_drop_prob: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm_kernel = LayerNorm(dim)
        self.norm_enc = LayerNorm(enc_dim)
        rates = dict(attn_drop_prob=attn_drop_prob, drop_prob=drop_prob)
        self.kernel_attn = KernelWindowAttention(dim, enc_dim, num_heads, qkv_bias, **rates)
        self.norm_ff1 = LayerNorm(dim)
        self.mlp1 = SwinMLP(dim, int(dim * mlp_ratio), drop_prob)
        self.norm_attn = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias, **rates)
        self.norm_ff2 = LayerNorm(dim)
        self.mlp2 = SwinMLP(dim, int(dim * mlp_ratio), drop_prob)
        self.drop_path = DropPath(path_drop_prob)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        r, s = self.window_size, self.shift_size
        x = pad_to_multiple(x, r)
        enc = pad_to_multiple(enc, r)
        hp, wp = x.shape[1], x.shape[2]
        windows = b * (hp // r) * (wp // r)

        def branch(y, batch):
            return self.drop_path(y, self.drop_path.draw(batch, generator, y.device))

        mask = shifted_window_attn_mask(hp, wp, r, s, x.device) if s > 0 else None
        xw = window_partition(cyclic_shift(x, s), r)
        ew = window_partition(cyclic_shift(enc, s), r)
        kw = xw + branch(self.kernel_attn(self.norm_kernel(xw), self.norm_enc(ew), generator),
                         windows)
        if s > 0:
            kw = torch.roll(kw, (s, s), dims=(1, 2))
        y = window_reverse(kw, r, hp, wp)
        y = y + branch(self.mlp1(self.norm_ff1(y), generator), b)
        yw = window_partition(cyclic_shift(y, s), r)
        aw = yw + branch(self.attn(self.norm_attn(yw), mask, generator), windows)
        if s > 0:
            aw = torch.roll(aw, (s, s), dims=(1, 2))
        y = window_reverse(aw, r, hp, wp)
        y = y + branch(self.mlp2(self.norm_ff2(y), generator), b)
        return y[:, :h, :w]


class PatchUnMerging(nn.Module):
    """Channel quarters -> 2x2 interleave (x0 -> (0,0), x1 -> (1,0), x2 ->
    (0,1), x3 -> (1,1)) -> ConvBN d/4 -> d/2 (``ksa.py:188-203``; JAX gives
    this ConvBN the decoder's momentum and its default eps)."""

    def __init__(self, dim: int, bn_momentum: float = 0.1):
        super().__init__()
        self.expansion = ConvBN(dim // 4, dim // 2, 3, bn_momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d = x.shape
        y = x.reshape(b, h, w, 2, 2, d // 4).permute(0, 1, 4, 2, 3, 5)
        return self.expansion(y.reshape(b, 2 * h, 2 * w, d // 4))


class KSAStage(nn.Module):
    """One decoder stage: its blocks (KSA blocks, or Swin blocks at the
    coarsest scale), then an optional ``PatchUnMerging``."""

    def __init__(self, blocks: Sequence[nn.Module], upsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.upsample = upsample

    def forward(self, x: torch.Tensor, enc: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        for block in self.blocks:
            if isinstance(block, SwinBlock):
                x = block(x, block.draw_masks(x.shape[0], generator, x.device), generator)
            else:
                x = block(x, enc, generator)
        return x if self.upsample is None else self.upsample(x)


class KSATransformerRegDecoder(nn.Module):
    """PPM at 1/32 and ConvBN laterals at 1/16, 1/8, 1/4; four stages
    coarse to fine with ``PatchUnMerging`` between; ConvBN, 3x3 VALID conv
    and sigmoid (``ksa.py:206-274``). Stochastic depth rises linearly over
    the decoder's blocks, ``path_drop_prob * i / (total - 1)``; the dropout
    rates reach every block, the coarsest stage's Swin blocks too, and
    ``bn_momentum`` every BatchNorm."""

    def __init__(self, enc_dims: Sequence[int], dec_dim: int,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 7,
                 ppm_proj: int = 512, attn_drop_prob: float = 0.0, drop_prob: float = 0.0,
                 path_drop_prob: float = 0.2, bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("the KSA decoder has four stages")
        d = dec_dim
        nf = [d // 8, d // 4, d // 2, d]
        c4, c8, c16, c32 = enc_dims
        ck = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
        self.ppm32 = PyramidPoolingModule(c32, ppm_proj, d, **ck)
        self.enc_conv16 = ConvBN(c16, nf[2], 3, **ck)
        self.enc_conv8 = ConvBN(c8, nf[1], 3, **ck)
        self.enc_conv4 = ConvBN(c4, nf[0], 3, **ck)
        total = sum(depths)
        pdp = [path_drop_prob * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            start = sum(depths[:i])
            blocks = []
            for j in range(depth):
                shift = 0 if j % 2 == 0 else window_size // 2
                rates = dict(attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
                             path_drop_prob=pdp[start + j])
                if i == len(depths) - 1:
                    blocks.append(SwinBlock(nf[i], num_heads[i], window_size, shift, **rates))
                else:
                    blocks.append(KSABlock(nf[i], nf[i], num_heads[i], window_size, shift,
                                           **rates))
            self.layers.append(KSAStage(blocks, PatchUnMerging(nf[i], bn_momentum) if i
                                        else None))
        out_ch = min(nf[0], 128)
        self.dec_conv4 = ConvBN(nf[0], out_ch, 3, **ck)
        self.out_conv = ValidConv(out_ch, 1, 3)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        e4, e8, e16, e32 = features
        x = self.layers[3](self.ppm32(e32), None, generator)
        x = self.layers[2](x, self.enc_conv16(e16), generator)
        x = self.layers[1](x, self.enc_conv8(e8), generator)
        x = self.layers[0](x, self.enc_conv4(e4), generator)
        out = self.out_conv(self.dec_conv4(x))
        return torch.sigmoid(out.float())


class ODA2KSARegModel(SwinDepthModel):
    """Swin encoder + KSA decoder. ``forward`` takes (B, H, W, 3) f32
    images and returns ``(depth, None)``: one f32 map at 1/4 scale less 2
    px, ``sigmoid * (max_depth - min_depth) + min_depth``. Activations run
    in ``dtype`` (parameters stay f32). In training mode BatchNorm takes
    batch statistics and stochastic depth and dropout draw from the
    ``generator`` given to ``forward``. ``use_checkpoint`` (on by default, as in the JAX
    model) recomputes each encoder block in the backward pass; the decoder
    has none."""

    def __init__(self, dec_dim: int, min_depth: float, max_depth: float,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dec_num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 7,
                 encoder_type: str = "large", drop_prob: float = 0.0,
                 attn_drop_prob: float = 0.0, path_drop_prob: float = 0.2,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5, use_checkpoint: bool = True,
                 dtype: torch.dtype = torch.float32, resize_to_multiple: bool = True,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__(min_depth, max_depth, encoder_type, path_drop_prob, use_checkpoint,
                         dtype, resize_to_multiple, encoder_kwargs)
        self.decoder = KSATransformerRegDecoder(
            self.encoder.num_features, dec_dim, depths, dec_num_heads, window_size,
            ppm_proj=min(512, dec_dim), attn_drop_prob=attn_drop_prob, drop_prob=drop_prob,
            path_drop_prob=path_drop_prob, bn_momentum=bn_momentum, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, None]:
        out = self.decoder(self.features(x, generator), generator)
        return out * (self.max_depth - self.min_depth) + self.min_depth, None

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section with the JAX
        package's defaults (``ksa.py:326-341``); ``overrides``
        (``use_checkpoint``, ``path_drop_prob``, ``dtype``, ...) go to the
        constructor."""
        kwargs = dict(
            dec_dim=opt["dec_dim"], depths=tuple(opt.get("depths", (2, 2, 2, 2))),
            dec_num_heads=tuple(opt.get("dec_num_heads",
                                        opt.get("num_heads_list", (4, 8, 16, 32)))),
            window_size=opt.get("window_size", 7), min_depth=min_depth, max_depth=max_depth,
            encoder_type=opt.get("encoder_type", "large"), drop_prob=opt.get("drop_prob", 0.0),
            attn_drop_prob=opt.get("attn_drop_prob", 0.0),
            bn_momentum=opt.get("bn_momentum", 0.1), bn_eps=opt.get("bn_eps", 1e-5))
        kwargs.update(overrides)
        return cls(**kwargs)
