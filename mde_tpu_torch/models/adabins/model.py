"""AdaBins (``adabins``): an EfficientNet-B5 U-Net and the mViT
adaptive-bin head (``mde_tpu/models/adabins/model.py``).

EfficientNet-B5 taps 4, 5, 6, 8 and 11 feed ``DecoderBN``, a U-Net of
bilinear upsamples and conv-BN-LeakyReLU pairs, to a 128-channel map at
1/2 scale. mViT embeds that map in 16x16 patches and runs four post-norm
transformer layers: token 0 regresses the normalised bin widths (ReLU +
0.1), tokens 1..128 are queries whose dot products with a 3x3 conv of the
map give 128 range-attention maps. A 1x1 conv and a softmax over the bins
weigh the bin centers into the depth. The attentions are plain einsums, as
JAX's are: no kernel of the port lies on this path.

Parameter names follow the released AdaBins state dict ("Checkpoint ver."),
the names ``mde_tpu.core.checkpoint.convert_adabins_model`` (``:397-456``)
converts from: ``encoder.original_model.*``, ``decoder.conv2``,
``decoder.up{1..4}._net.{0,1,3,4}``, ``decoder.conv3``,
``adaptive_bins_layer.{embedding_conv, patch_transformer.embedding_encoder,
patch_transformer.positional_encodings,
patch_transformer.transformer_encoder.layers.{i}.{self_attn.in_proj_weight,
self_attn.in_proj_bias, self_attn.out_proj, linear1, linear2, norm1,
norm2}, regressor.{0,2,4}}``, ``conv_out``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import drop
from ...ops.conv import Conv1x1, ValidConv, ZeroPadConv
from ...ops.drop import Dropout
from ...ops.init import lecun_normal_
from ...ops.pad import pad2d
from ...ops.resize import resize_bilinear
from ...ops.tnn import BatchNorm, LayerNorm, Linear
from ..efficientnet import EfficientNetEncoder

N_QUERIES = 128
EMBEDDING_DIM = 128


class LecunLinear(Linear):
    """A Linear drawn as flax's default ``nn.Dense``: lecun normal, zero bias."""

    def init_own_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight.data, generator)


class MultiHeadAttention(nn.Module):
    """flax 0.12's ``nn.MultiHeadDotProductAttention`` (not torch's
    ``nn.MultiheadAttention``) over (B, S, E) tokens, under torch's packed
    names ``in_proj_weight`` (q | k | v rows), ``in_proj_bias`` and
    ``out_proj``: the query divided by sqrt(head_dim) in the activation
    dtype before the product, the softmax in that dtype, then in training
    dropout on the probabilities with one (q, k) keep mask shared by every
    image and head (``broadcast_dropout``), applied as flax does, times
    keep / (1 - rate)."""

    def __init__(self, dim: int, num_heads: int, attn_drop_prob: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop_prob = attn_drop_prob
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = LecunLinear(dim, dim)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        for w in self.in_proj_weight.data.chunk(3):
            lecun_normal_(w, generator)
        self.in_proj_bias.data.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, s, e = x.shape
        nh = self.num_heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, s, nh, e // nh) for t in qkv.chunk(3, dim=-1))
        q = q / torch.tensor(math.sqrt(e // nh), dtype=x.dtype)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(dim=-1)
        if self.training and self.attn_drop_prob > 0:
            # no batch dimension: the same mask on every rank of a global batch
            keep = drop._keep_mask((1, 1, s, s), self.attn_drop_prob, generator, x.device, False)
            keep_prob = torch.tensor(1.0 - self.attn_drop_prob, dtype=x.dtype, device=x.device)
            attn = attn * (keep.to(x.dtype) / keep_prob)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, e))


class TransformerEncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer``'s defaults as the JAX layer has them
    (``model.py:24-53``): post-norm, attention then an FF of ``ff_dim``
    whose ``activation`` is ReLU (an attribute, as torch's layer has it),
    dropout ``drop_prob`` on the attention probabilities, on the
    attention's output, after the activation and on the FF's output."""

    def __init__(self, dim: int, num_heads: int = 4, ff_dim: int = 1024,
                 drop_prob: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads, drop_prob)
        self.linear1 = LecunLinear(dim, ff_dim)
        self.linear2 = LecunLinear(ff_dim, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.drop = Dropout(drop_prob)
        self.activation = F.relu

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x, generator), generator))
        y = self.drop(self.activation(self.linear1(x)), generator)
        return self.norm2(x + self.drop(self.linear2(y), generator))


class PatchTransformerEncoder(nn.Module):
    """The 16x16 stride-16 patch embedding, learned (500, E) positional
    encodings sliced to the token count (drawn U[0, 1), flax's
    ``uniform``), and ``num_layers`` transformer layers; (B, S, E)."""

    def __init__(self, in_ch: int, embedding_dim: int = EMBEDDING_DIM, patch_size: int = 16,
                 num_heads: int = 4, num_layers: int = 4, drop_prob: float = 0.1):
        super().__init__()
        self.embedding_encoder = ValidConv(in_ch, embedding_dim, patch_size, stride=patch_size)
        self.positional_encodings = nn.Parameter(torch.zeros(500, embedding_dim))
        self.transformer_encoder = nn.ModuleDict({"layers": nn.ModuleList(
            TransformerEncoderLayer(embedding_dim, num_heads, drop_prob=drop_prob)
            for _ in range(num_layers))})

    def init_own_parameters(self, generator: torch.Generator) -> None:
        self.positional_encodings.data.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding_encoder(x)
        b, hp, wp, e = emb.shape
        if hp * wp > self.positional_encodings.shape[0]:
            raise ValueError(f"{hp}x{wp} patches exceed the "
                             f"{self.positional_encodings.shape[0]} positional encodings")
        emb = emb.reshape(b, hp * wp, e) + self.positional_encodings[:hp * wp].to(emb.dtype)
        for layer in self.transformer_encoder["layers"]:
            emb = layer(emb, generator)
        return emb


class MiniViT(nn.Module):
    """The adaptive-bin head ``mViT`` (``model.py:87-128``): returns the
    (B, n_bins) f32 normalised bin widths (the regressor's LeakyReLU 0.01
    layers in the activation dtype, then ReLU + 0.1 and the normalisation
    in f32) and the (B, h, w, 128) range-attention maps. Tokens 1..128 are
    the queries, so the map needs at least 129 patches: JAX would size
    ``conv_out`` from fewer queries there and no released weight fits.
    ``embedding_dim`` and ``num_heads`` are AdaBins' 128 and 4 unless given
    (``oda_bins`` takes its decoder's width)."""

    n_queries = N_QUERIES

    def __init__(self, in_ch: int, n_bins: int, drop_prob: float = 0.1,
                 embedding_dim: int = EMBEDDING_DIM, num_heads: int = 4):
        super().__init__()
        self.patch_transformer = PatchTransformerEncoder(in_ch, embedding_dim,
                                                         num_heads=num_heads,
                                                         drop_prob=drop_prob)
        self.embedding_conv = ZeroPadConv(in_ch, embedding_dim, 3)
        self.regressor = nn.Sequential(
            LecunLinear(embedding_dim, 256), nn.LeakyReLU(0.01), LecunLinear(256, 256),
            nn.LeakyReLU(0.01), LecunLinear(256, n_bins))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tgt = self.patch_transformer(x, generator)
        if tgt.shape[1] < N_QUERIES + 1:
            raise ValueError(f"a {x.shape[1]}x{x.shape[2]} map gives {tgt.shape[1]} patches of "
                             f"16x16; mViT takes {N_QUERIES} queries after the regression "
                             f"token, so it needs at least {N_QUERIES + 1}")
        queries = tgt[:, 1:N_QUERIES + 1]
        maps = torch.einsum("bhwc,bqc->bhwq", self.embedding_conv(x), queries)
        y = F.relu(self.regressor(tgt[:, 0]).float()) + 0.1
        return y / y.sum(dim=1, keepdim=True), maps


class UpSampleBN(nn.Module):
    """Align-corners bilinear resize onto the skip's size, concat with the
    skip, then (3x3 conv, BatchNorm, LeakyReLU 0.01) twice: ``_net.{0..5}``."""

    def __init__(self, in_ch: int, out_ch: int, bn_momentum: float = 0.1):
        super().__init__()
        self._net = nn.Sequential(
            ZeroPadConv(in_ch, out_ch, 3), BatchNorm(out_ch, momentum=bn_momentum),
            nn.LeakyReLU(0.01), ZeroPadConv(out_ch, out_ch, 3),
            BatchNorm(out_ch, momentum=bn_momentum), nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x, skip.shape[1:3], align_corners=True)
        return self._net(torch.cat([x, skip], dim=-1))


class DecoderBN(nn.Module):
    """The U-Net over taps 4, 5, 6, 8 and 11 (``model.py:156-181``). The
    reference's ``conv2`` is a 1x1 conv with padding 1: its map grows by
    2 px, which the first resize onto the skip absorbs; kept for the
    released weights."""

    def __init__(self, channels: Sequence[int], num_classes: int = 128):
        super().__init__()
        f = channels[11]
        self.conv2 = Conv1x1(f, f, bias=True)
        self.up1 = UpSampleBN(f + channels[8], f // 2)
        self.up2 = UpSampleBN(f // 2 + channels[6], f // 4)
        self.up3 = UpSampleBN(f // 4 + channels[5], f // 8)
        self.up4 = UpSampleBN(f // 8 + channels[4], f // 16)
        self.conv3 = ZeroPadConv(f // 16, num_classes, 3)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.conv2(pad2d(features[11], 1, 1, 1, 1, mode="zeros"))
        x = self.up1(x, features[8])
        x = self.up2(x, features[6])
        x = self.up3(x, features[5])
        return self.conv3(self.up4(x, features[4]))


class UnetAdaptiveBins(nn.Module):
    """``forward`` takes (B, H, W, 3) f32 images and returns ``(pred,
    bin_edges)``: the f32 (B, H/2, W/2, 1) expected depth over ``n_bins``
    bins (the f32 softmax of ``conv_out`` of the range-attention maps
    weighing the bin centers), and the (B, n_bins + 1) f32 bin edges, the
    cumulative sum of ``min_val`` and the widths times (max_val -
    min_val). ``dtype`` is the activations' (the input is cast to it);
    ``drop_prob`` the transformer layers' dropout (0.1 as in JAX, which
    has no option for it); ``encoder_kwargs`` override the encoder's B5
    multipliers."""

    def __init__(self, n_bins: int = 100, min_val: float = 0.1, max_val: float = 10.0,
                 drop_prob: float = 0.1, dtype: torch.dtype = torch.float32,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__()
        self.min_val = min_val
        self.max_val = max_val
        self.dtype = dtype
        self.encoder = EfficientNetEncoder(**(encoder_kwargs or {}))
        self.decoder = DecoderBN(self.encoder.channels)
        self.adaptive_bins_layer = MiniViT(128, n_bins, drop_prob)
        self.conv_out = Conv1x1(N_QUERIES, n_bins, bias=True)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        unet_out = self.decoder(self.encoder(x.to(self.dtype)))
        widths, maps = self.adaptive_bins_layer(unet_out, generator)
        out = self.conv_out(maps).float().softmax(dim=-1)
        widths = F.pad((self.max_val - self.min_val) * widths, (1, 0), value=self.min_val)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return (out * centers[:, None, None, :]).sum(dim=-1, keepdim=True), edges

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section as the JAX build does
        (``num_bins``, default 256; the depth range from the dataset)."""
        kwargs = dict(n_bins=opt.get("num_bins", 256), min_val=min_depth, max_val=max_depth)
        kwargs.update(overrides)
        return cls(**kwargs)
