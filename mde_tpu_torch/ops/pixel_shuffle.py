"""Pixel shuffle and unshuffle of NHWC tensors in torch's NCHW channel order
(``mde_tpu/ops/pixel_shuffle.py``): ``nn.PixelShuffle(r)`` puts input
channel ``c * r^2 + i * r + j`` at output pixel (h * r + i, w * r + j).
Both are a reshape and a permute."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C * r^2) -> (B, H * r, W * r, C)."""
    b, h, w, c = x.shape
    if c % (r * r):
        raise ValueError(f"pixel_shuffle: {c} channels are not a multiple of {r * r}")
    x = x.reshape(b, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H * r, W * r, C) -> (B, H, W, C * r^2), the inverse of
    :func:`pixel_shuffle`."""
    b, hr, wr, c = x.shape
    if hr % r or wr % r:
        raise ValueError(f"pixel_unshuffle: {hr}x{wr} is not a multiple of {r}")
    x = x.reshape(b, hr // r, r, wr // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, hr // r, wr // r, c * r * r)
