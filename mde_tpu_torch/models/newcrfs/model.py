"""NewCRFs (``newcrfs``, NeW CRFs, Yuan et al., CVPR 2022): a Swin backbone,
a PSP bottleneck at 1/32 and four cascaded neural-window CRF stages
(``mde_tpu/models/newcrfs/model.py``).

The Swin variant zero-pads (to patch multiples, odd maps before a merge,
window multiples), its window size is the last two characters of the
version string, and its stochastic depth is 0.3 unless the build is given
``path_drop_prob``. Between CRF stages a PixelShuffle(2) upsamples; the head
is a 3x3 conv, a sigmoid and a x4 bilinear upsample (align_corners=False),
or with ``up_mode="mask"`` a convex-combination x4 upsample, times
``max_depth``.

Parameter names follow the reference torch state dict (``backbone.*``,
``decoder.psp_modules.{i}.1.{conv,gn,bn}``, ``decoder.bottleneck.{conv,bn}``,
``crf{k}.*``, ``disp_head1.conv1``; ``mask_head.{0,2}`` with the mask
upsample), the names ``mde_tpu.core.checkpoint.convert_newcrfs_model``
converts from.

Under a ``torch.profiler`` profile a forward is the spans
``mde.newcrfs.encoder``, ``mde.newcrfs.psp``, ``mde.newcrfs.crf`` (one a
stage, coarsest first, each with the pixel shuffle after it; counters
``tokens``, the B * H * W of the stage's map, and ``pad_tokens``, the
tokens its zero padding to window multiples adds) and ``mde.newcrfs.head``
(``utils.profiling``; inside ``mde.serve.forward`` when served).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.conv import ZeroPadConv
from ...ops.pixel_shuffle import pixel_shuffle
from ...ops.resize import adaptive_avg_pool2d, resize_bilinear
from ...ops.tnn import BatchNorm, GroupNorm
from ...utils.profiling import count, span
from ..swin import SwinTransformer
from .layers import NewCRF

_VERSIONS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 in_channels=(96, 192, 384, 768)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                 in_channels=(128, 256, 512, 1024)),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                  in_channels=(192, 384, 768, 1536)),
}
CRF_HEADS = (4, 8, 16, 32)


class AdaptivePool(nn.Module):
    """NHWC ``nn.AdaptiveAvgPool2d((size, size))``, no parameters."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool2d(x, (self.size, self.size))


class ConvModule(nn.Module):
    """mmcv's ConvModule as the reference's PSP head builds it: a bias-free
    conv (zero padding), a norm (``gn``: GroupNorm, ``bn``: BatchNorm), ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, norm: str,
                 groups: int = 0, bn_eps: float = 1e-5):
        super().__init__()
        self.conv = ZeroPadConv(in_ch, out_ch, kernel_size, bias=False)
        self.norm_name = norm
        if norm == "gn":
            self.gn = GroupNorm(groups, out_ch, eps=bn_eps)
        else:
            self.bn = BatchNorm(out_ch, eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, self.norm_name)(self.conv(x)))


class PSP(nn.Module):
    """Pyramid pooling bottleneck (``model.py:39-84``): for each pool scale
    (1, 2, 3, 6), an adaptive average pool, a bias-free 1x1 conv to
    ``channels``, GroupNorm (min(256, channels) groups) at scale 1 and
    BatchNorm elsewhere, ReLU and an align_corners=False bilinear resize
    back; concatenated after the input, a 3x3 bias-free conv, BatchNorm and
    ReLU."""

    def __init__(self, in_ch: int, channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), bn_eps: float = 1e-5):
        super().__init__()
        self.psp_modules = nn.ModuleList(
            nn.Sequential(AdaptivePool(scale),
                          ConvModule(in_ch, channels, 1, "gn" if scale == 1 else "bn",
                                     min(256, channels), bn_eps))
            for scale in pool_scales)
        self.bottleneck = ConvModule(in_ch + len(pool_scales) * channels, channels, 3, "bn",
                                     bn_eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        outs = [x] + [resize_bilinear(m(x), (h, w), align_corners=False)
                      for m in self.psp_modules]
        return self.bottleneck(torch.cat(outs, dim=-1))


def convex_upsample_4x(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT-style convex-combination x4 upsample of a 1-channel map
    (``model.py:87-108``). ``disp``: (B, H, W, 1); ``mask``: (B, H, W, 144)
    logits whose channel c is (tap c // 16, sy (c % 16) // 4, sx c % 4).
    Each of the 4x4 subpixels is a softmax-weighted combination of the 3x3
    zero-padded neighbourhood, taps in row-major (dy, dx) order; in f32."""
    b, h, w, _ = disp.shape
    m = mask.float().reshape(b, h, w, 9, 16).softmax(dim=3).reshape(b, h, w, 9, 4, 4)
    dpad = F.pad(disp.float(), (0, 0, 1, 1, 1, 1))
    taps = torch.stack([dpad[:, dy:dy + h, dx:dx + w, 0]
                        for dy in range(3) for dx in range(3)], dim=-1)
    up = (m * taps[..., :, None, None]).sum(dim=3)  # (b, h, w, 4, 4)
    return up.permute(0, 1, 3, 2, 4).reshape(b, 4 * h, 4 * w, 1)


class DispHead(nn.Module):
    """3x3 conv to one channel and a sigmoid, in f32 (``disp_head1``)."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.conv1 = ZeroPadConv(in_ch, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv1(x).float())


class NewCRFDepth(nn.Module):
    """``forward`` takes (B, H, W, 3) f32 images and returns one f32 depth
    map (B, 4 * ceil(H / 4), 4 * ceil(W / 4), 1), as the JAX model does.
    Activations run in ``dtype`` (parameters stay f32). In training mode
    BatchNorm takes batch statistics and stochastic depth draws from the
    ``generator`` given to ``forward``. ``use_checkpoint`` (off by default,
    as in JAX) recomputes each encoder block in the backward pass.

    ``version``: ``{tiny,base,large}{window}`` (``large07``: Swin-L, window
    7), or ``custom{window}`` with ``encoder_kwargs`` holding the backbone's
    arguments and its ``in_channels`` and the CRF widths ``crf_dims``."""

    def __init__(self, version: str = "large07", min_depth: float = 0.001,
                 max_depth: float = 10.0, frozen_stages: int = -1, up_mode: str = "bilinear",
                 dtype: torch.dtype = torch.float32, use_checkpoint: bool = False,
                 encoder_kwargs: Optional[dict] = None, path_drop_prob: float = 0.3):
        super().__init__()
        if up_mode not in ("bilinear", "mask"):
            raise ValueError(f"up_mode {up_mode!r}: expected 'bilinear' or 'mask'")
        self.min_depth, self.max_depth = min_depth, max_depth
        self.up_mode = up_mode
        self.dtype = dtype
        window_size = int(version[-2:])
        if version[:-2] == "custom":
            cfg = dict(encoder_kwargs or {})
            in_channels = tuple(cfg.pop("in_channels"))
            crf_dims = tuple(cfg.pop("crf_dims"))
            backbone_args = cfg
        else:
            v = _VERSIONS[version[:-2]]
            in_channels = v["in_channels"]
            crf_dims = (128, 256, 512, 1024)  # every version (reference ``:71``)
            backbone_args = dict(embed_dim=v["embed_dim"], depths=v["depths"],
                                 num_heads=v["num_heads"])
        self.backbone = SwinTransformer(
            window_size=window_size, path_drop_prob=path_drop_prob,
            frozen_stages=frozen_stages, use_checkpoint=use_checkpoint, padding_mode="zeros",
            **backbone_args)
        # half the coarsest CRF width, so that the value chain lines up after
        # crf3's pixel shuffle (reference: 512)
        psp_channels = crf_dims[3] // 2
        self.decoder = PSP(in_channels[3], psp_channels)
        # each stage's v: the PSP output, then the finer stage's shuffled output
        v_dims = (crf_dims[1] // 4, crf_dims[2] // 4, crf_dims[3] // 4, psp_channels)
        for k in range(4):
            self.add_module(f"crf{k}", NewCRF(in_channels[k], v_dims[k], crf_dims[k],
                                              CRF_HEADS[k], window_size=7))
        self.disp_head1 = DispHead(crf_dims[0])
        if up_mode == "mask":
            self.mask_head = nn.Sequential(ZeroPadConv(crf_dims[0], 64, 3), nn.ReLU(),
                                           ZeroPadConv(64, 16 * 9, 1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with span("mde.newcrfs.encoder"):
            feats = self.backbone(x.to(self.dtype), generator)
        with span("mde.newcrfs.psp"):
            e = self.decoder(feats[3])
        for k in (3, 2, 1, 0):
            with span("mde.newcrfs.crf"):
                crf = getattr(self, f"crf{k}")
                b, h, w, _ = feats[k].shape
                r = crf.crf_layer.blocks[0].window_size
                count("tokens", b * h * w)
                count("pad_tokens", b * ((h + (-h) % r) * (w + (-w) % r) - h * w))
                e = crf(feats[k], e, generator)
                if k:
                    e = pixel_shuffle(e, 2)
        with span("mde.newcrfs.head"):
            d = self.disp_head1(e)
            if self.up_mode == "mask":
                d = convex_upsample_4x(d, self.mask_head(e))
            else:
                d = resize_bilinear(d, (d.shape[1] * 4, d.shape[2] * 4), align_corners=False)
            return d * self.max_depth

    @classmethod
    def build(cls, opt, min_depth: float, max_depth: float, **overrides):
        """Construct from a config's ``model`` section with the JAX build's
        defaults (``model.py:184-193``); ``overrides`` (``dtype``,
        ``use_checkpoint``, ``path_drop_prob``, ``encoder_kwargs``, ...) go
        to the constructor."""
        kwargs = dict(version=opt.get("version", "large07"), min_depth=min_depth,
                      max_depth=max_depth, frozen_stages=opt.get("frozen_stages", -1),
                      up_mode=opt.get("up_mode", "bilinear"))
        kwargs.update(overrides)
        return cls(**kwargs)
