"""Plain NeW CRFs (Yuan et al., "Neural Window Fully-connected CRFs for
Monocular Depth Estimation", CVPR 2022, arXiv:2203.01502) on NHWC tensors,
as ``json/kitti/newcrfs/newcrfs_github_eval.json`` builds it (``large07``).

- Encoder: Swin-L with 7x7 windows (embed 192, depths 2-2-18-2, heads
  6-12-24-48) that pads with zeros: the image to patch multiples, an odd
  map before a patch merge, each block's normalised tokens to window
  multiples (the -100 region mask of shifted windows is built on the
  padded grid, and the padded tokens attend). Stochastic depth rises to
  0.3 over the blocks, inert in eval; every stage output goes through its
  LayerNorm ``norm{i}``.
- PSP bottleneck at 1/32 (``decoder``): for the pool scales 1, 2, 3 and 6,
  an adaptive average pool, a bias-free 1x1 conv to 512 channels, GroupNorm
  in 256 groups at scale 1 (two values a group) and BatchNorm elsewhere,
  ReLU, an align_corners=False bilinear resize back; concatenated after the
  input, a bias-free 3x3 conv to 512, BatchNorm, ReLU.
- Four neural-window CRF stages ``crf3`` .. ``crf0`` at widths 1024, 512,
  256 and 128 with 32, 16, 8 and 4 heads, coarsest first. A stage takes the
  encoder's map x and the coarser estimate v, each through a biased 3x3
  conv (``proj_x``, ``proj_v``) where its width is not the stage's, then two
  blocks (shift 0, then 3): LayerNorm of x, x and v zero-padded to window
  multiples, shifted and partitioned together, softmax(q k^T / sqrt(d) +
  relative-position bias [+ mask]) v with q and k from one biased linear of
  x and v as it is, a projection, the crop, the residual, LayerNorm, the
  MLP (exact GELU) and its residual; then the stage's LayerNorm
  ``norm_crf``. A PixelShuffle(2) follows each stage but the last.
- Head: a biased 3x3 conv to one channel, a sigmoid, a x4 bilinear
  upsample (align_corners=False), times ``max_depth``.

Departures from the description: none in eval, which is all the serving
cell runs. Training is not built here (no dropout path in the CRF blocks);
the version ``custom{window}`` takes the sizes from ``encoder_kwargs``
(``in_channels`` and ``crf_dims`` beside the encoder's) for the tests'
small models. The encoder reuses ``swin.py``'s classes with only the
padding overridden (that file pads with the border, as the other
configurations do).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm, Dropout, LayerNorm, Linear, Numerics, apply_keep, attend,
                     conv2d, relative_index, shift, shift_mask, unshift, unwindows, windows)
from .swin import Mlp, PatchEmbed, PatchMerging, SwinBlock, SwinEncoder

LARGE = dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
             in_channels=(192, 384, 768, 1536), crf_dims=(128, 256, 512, 1024))
CRF_HEADS = (4, 8, 16, 32)
PATH_RATE = 0.3
POOL_SCALES = (1, 2, 3, 6)


def pad_zeros(x: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Zero rows below and zero columns right of NHWC x."""
    if bottom == 0 and right == 0:
        return x
    return F.pad(x, (0, 0, 0, right, 0, bottom))


def pad_zeros_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return pad_zeros(x, (-x.shape[1]) % multiple, (-x.shape[2]) % multiple)


class ZeroPadEmbed(PatchEmbed):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_zeros_to(x, self.patch)
        return self.norm(conv2d(self.num, x, self.proj.weight, self.proj.bias, self.patch))


class ZeroPadMerging(PatchMerging):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_zeros(x, x.shape[1] % 2, x.shape[2] % 2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class ZeroPadBlock(SwinBlock):
    def forward(self, x, path_attn, path_mlp, proj_keep, mlp_keep1, mlp_keep2):
        _, h, w, _ = x.shape
        r, s = self.window, self.shift_size
        y = pad_zeros_to(self.norm1(x), r)
        hp, wp = y.shape[1], y.shape[2]
        mask = shift_mask(hp, wp, r, s, x.device) if s > 0 else None
        y = self.attn(windows(shift(y, s), r), mask, proj_keep)
        y = unshift(unwindows(y, r, hp, wp), s)[:, :h, :w]
        x = x + apply_keep(y, path_attn, self.path_rate)
        y = self.mlp(self.norm2(x), mlp_keep1, mlp_keep2)
        return x + apply_keep(y, path_mlp, self.path_rate)


class ZeroPadSwin(SwinEncoder):
    """``SwinEncoder``'s forward over zero-padding parts: its own
    construction, with every stage's window fixed and no dropout."""

    def __init__(self, num: Numerics, embed: int, depths, heads, window: int,
                 path_rate: float, checkpoint_blocks: bool):
        nn.Module.__init__(self)
        self.checkpoint_blocks, self.out_norms = checkpoint_blocks, True
        self.patch_embed = ZeroPadEmbed(num, embed)
        self.pos_drop = Dropout(0.0)
        total = sum(depths)
        rates = [path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim, start = embed * 2 ** i, sum(depths[:i])
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                ZeroPadBlock(num, dim, heads[i], window, 0 if j % 2 == 0 else window // 2,
                             rates[start + j], 0.0) for j in range(depth))
            stage.downsample = ZeroPadMerging(num, dim) if i < len(depths) - 1 else None
            self.layers.append(stage)
            self.add_module(f"norm{i}", LayerNorm(num, dim))


class ZeroConv(nn.Module):
    """k x k convolution after k // 2 zero pixels on each side."""

    def __init__(self, num: Numerics, cin: int, cout: int, k: int, bias: bool):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.weight.shape[-1] // 2
        return conv2d(self.num, F.pad(x, (0, 0, p, p, p, p)), self.weight, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, num: Numerics, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.num, self.groups, self.eps = num, groups, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups, self.weight, self.bias,
                         self.eps)
        return y.permute(0, 2, 3, 1).to(self.num.act_dtype)


class ConvNormReLU(nn.Module):
    """Bias-free zero-padded conv, GroupNorm (``gn``) or BatchNorm (``bn``),
    ReLU."""

    def __init__(self, num: Numerics, cin: int, cout: int, k: int, norm: str):
        super().__init__()
        self.conv = ZeroConv(num, cin, cout, k, bias=False)
        self.norm = norm
        if norm == "gn":
            self.gn = GroupNorm(num, min(256, cout), cout)
        else:
            self.bn = BatchNorm(num, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, self.norm)(self.conv(x)))


class Pool(nn.Module):
    def __init__(self, num: Numerics, size: int):
        super().__init__()
        self.num, self.size = num, size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.adaptive_avg_pool2d(x.float().permute(0, 3, 1, 2), self.size)
        return y.permute(0, 2, 3, 1).to(self.num.act_dtype)


def bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel (align_corners=False) bilinear resize of NHWC x in f32."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class PSP(nn.Module):
    def __init__(self, num: Numerics, cin: int, channels: int):
        super().__init__()
        self.psp_modules = nn.ModuleList(
            nn.Sequential(Pool(num, s), ConvNormReLU(num, cin, channels, 1,
                                                     "gn" if s == 1 else "bn"))
            for s in POOL_SCALES)
        self.bottleneck = ConvNormReLU(num, cin + len(POOL_SCALES) * channels, channels, 3,
                                       "bn")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (x.shape[1], x.shape[2])
        outs = [x] + [bilinear(m(x), size) for m in self.psp_modules]
        return self.bottleneck(torch.cat(outs, dim=-1))


class CRFAttention(nn.Module):
    def __init__(self, num: Numerics, dim: int, heads: int, window: int):
        super().__init__()
        self.num, self.heads, self.window = num, heads, window
        self.qk = Linear(num, dim, 2 * dim)
        self.proj = Linear(num, dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = x.shape[-1]
        idx = relative_index(self.window, x.device)
        bias = self.relative_position_bias_table[idx].permute(2, 0, 1).float()
        add = bias if mask is None else bias[None] + mask[:, None]
        q, k = self.qk(x).split(c, dim=-1)
        return self.proj(attend(self.num, q, k, v, self.heads, (c // self.heads) ** -0.5, add))


class CRFBlock(nn.Module):
    def __init__(self, num: Numerics, dim: int, heads: int, window: int, shift_size: int):
        super().__init__()
        self.window, self.shift_size = window, shift_size
        self.norm1 = LayerNorm(num, dim)
        self.attn = CRFAttention(num, dim, heads, window)
        self.norm2 = LayerNorm(num, dim)
        self.mlp = Mlp(num, dim, 4 * dim, 0.0)

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        r, s = self.window, self.shift_size
        y = pad_zeros_to(self.norm1(x), r)
        v = pad_zeros_to(v, r)
        hp, wp = y.shape[1], y.shape[2]
        if v.shape[1:3] != y.shape[1:3]:
            raise ValueError(f"v {tuple(v.shape)} and x {tuple(y.shape)} pad to other grids")
        mask = shift_mask(hp, wp, r, s, x.device) if s > 0 else None
        y = self.attn(windows(shift(y, s), r), windows(shift(v, s), r), mask)
        x = x + unshift(unwindows(y, r, hp, wp), s)[:, :h, :w]
        return x + self.mlp(self.norm2(x), None, None)


class CRFStage(nn.Module):
    def __init__(self, num: Numerics, in_dim: int, v_dim: int, dim: int, heads: int,
                 window: int = 7, depth: int = 2):
        super().__init__()
        self.proj_x = ZeroConv(num, in_dim, dim, 3, bias=True) if in_dim != dim else None
        self.proj_v = ZeroConv(num, v_dim, dim, 3, bias=True) if v_dim != dim else None
        self.crf_layer = nn.Module()
        self.crf_layer.blocks = nn.ModuleList(
            CRFBlock(num, dim, heads, window, 0 if j % 2 == 0 else window // 2)
            for j in range(depth))
        self.norm_crf = LayerNorm(num, dim)

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.proj_x is not None:
            x = self.proj_x(x)
        if self.proj_v is not None:
            v = self.proj_v(v)
        for block in self.crf_layer.blocks:
            x = block(x, v)
        return self.norm_crf(x)


class DispHead(nn.Module):
    def __init__(self, num: Numerics, dim: int):
        super().__init__()
        self.conv1 = ZeroConv(num, dim, 1, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv1(x).float())


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


class NewCRFs(nn.Module):
    """``model``: the configuration's model section (``version``
    ``large07``, or ``custom{window}`` with ``encoder_kwargs``)."""

    def __init__(self, num: Numerics, model: dict, max_depth: float,
                 checkpoint_blocks: bool = True):
        super().__init__()
        self.num, self.max_depth = num, max_depth
        version = model["version"]
        window = int(version[-2:])
        if version[:-2] == "custom":
            sizes = dict(model["encoder_kwargs"])
        elif version[:-2] == "large":
            sizes = LARGE
        else:
            raise ValueError(f"no reference for version {version!r}")
        ins, dims = sizes["in_channels"], sizes["crf_dims"]
        self.backbone = ZeroPadSwin(num, sizes["embed_dim"], sizes["depths"],
                                    sizes["num_heads"], window, PATH_RATE, checkpoint_blocks)
        psp = dims[3] // 2
        self.decoder = PSP(num, ins[3], psp)
        v_dims = (dims[1] // 4, dims[2] // 4, dims[3] // 4, psp)
        for k in range(4):
            self.add_module(f"crf{k}", CRFStage(num, ins[k], v_dims[k], dims[k], CRF_HEADS[k]))
        self.disp_head1 = DispHead(num, dims[0])

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        feats = self.backbone(x.to(self.num.act_dtype), generator)
        e = self.decoder(feats[3])
        for k in (3, 2, 1, 0):
            e = getattr(self, f"crf{k}")(feats[k], e)
            if k:
                e = pixel_shuffle(e, 2)
        d = self.disp_head1(e)
        d = bilinear(d, (4 * d.shape[1], 4 * d.shape[2]))
        return d * self.max_depth, None


def build(config: dict, num: Numerics, input_hw: Tuple[int, int],
          checkpoint_blocks: bool) -> NewCRFs:
    return NewCRFs(num, config["model"], config["max_depth"], checkpoint_blocks)
