"""The ODA encoder (``mde_tpu/models/oda/encoder.py``): Swin-L/384 with
window 12 behind an align-corners bilinear resize to the nearest multiples
of 384 (352x1216 -> 384x1152, 352x704 -> 384x768); the four stage outputs
without output norms.

Its blocks follow timm's min-window rule (``shift_collapse``): at 384x768
stage 4 is 12x24 tokens, one window high, so its blocks run unshifted and
unmasked. Every stage's window is 12 wherever the resize runs (no side
shorter than 384, so no stage narrower than 12 tokens). Without the resize
the windows depend on the input: ``input_size`` fixes them at build, as
JAX's tables are sized by its first call (a 64x64 input gives windows 12,
8, 4 and 2), and a call at a size that needs other windows raises.

Parameter names: ``backbone.*`` as the port's Swin's (the names
``mde_tpu.core.checkpoint.convert_swin_backbone`` converts from), without
``norm{i}``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.resize import resize_bilinear
from ..swin import SwinTransformer


def oda_resize_policy(h: int, w: int) -> Tuple[int, int]:
    """Each side rounded to the nearest positive multiple of 384."""
    return (max(384, round(h / 384) * 384), max(384, round(w / 384) * 384))


class ODASwinEncoder(nn.Module):
    """Swin-L (embed 192, depths (2, 2, 18, 2), heads (6, 12, 24, 48),
    window 12) with dropout ``drop_prob``, attention dropout
    ``attn_drop_prob`` and stochastic depth ``path_drop_prob`` (0.1, 0 and
    0.1, as JAX's; ``encoder_kwargs`` override any of these), ``shift_collapse``,
    no output norms; ``use_checkpoint`` recomputes each block in the
    backward pass (off, as in JAX). The input is resized in f32, then cast
    to ``dtype``."""

    def __init__(self, window_size: int = 12, drop_prob: float = 0.1,
                 attn_drop_prob: float = 0.0, path_drop_prob: float = 0.1,
                 resize_to_multiple: bool = True, input_size: Optional[Tuple[int, int]] = None,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 encoder_kwargs: Optional[dict] = None):
        super().__init__()
        self.resize_to_multiple = resize_to_multiple
        self.dtype = dtype
        kwargs = dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                      window_size=window_size, drop_prob=drop_prob,
                      attn_drop_prob=attn_drop_prob, path_drop_prob=path_drop_prob)
        kwargs.update(encoder_kwargs or {})
        self.backbone = SwinTransformer(
            use_checkpoint=use_checkpoint, shift_collapse=True,
            input_size=None if resize_to_multiple else input_size, out_norms=False, **kwargs)

    def grid(self, img_size: Tuple[int, int]) -> Tuple[int, int]:
        """The 1/32 (stage 4) token grid of an ``img_size`` input: after the
        resize where it runs; the patch embedding and each merge round
        up."""
        h, w = (oda_resize_policy(*img_size) if self.resize_to_multiple
                else (int(img_size[0]), int(img_size[1])))
        return -(-h // 32), -(-w // 32)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        if self.resize_to_multiple:
            x = resize_bilinear(x, oda_resize_policy(x.shape[1], x.shape[2]),
                                align_corners=True)
        return self.backbone(x.to(self.dtype), generator)
