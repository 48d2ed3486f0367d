"""Bilinear resize of NHWC tensors (``mde_tpu/ops/resize.py``): computed in
f32 and cast back, with ``F.interpolate``'s semantics."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """NHWC bilinear resize matching ``F.interpolate(..., mode='bilinear')``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[1:3]) == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=size, mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def upsample2d(x: torch.Tensor, scale: int, align_corners: bool = True) -> torch.Tensor:
    """``nn.UpsamplingBilinear2d(scale_factor=scale)`` on NHWC."""
    return resize_bilinear(x, (x.shape[1] * scale, x.shape[2] * scale), align_corners)
