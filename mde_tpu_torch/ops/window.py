"""Shifted-window utilities on NHWC tensors (``mde_tpu/ops/window.py``).

Windows are folded into the batch dim, batch-major: window ``w`` of a
(B, H, W, C) map is window ``w % nW`` of image ``w // nW``.
"""

from __future__ import annotations

import functools

import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, window_size**2, C)."""
    b, h, w, c = x.shape
    r = window_size
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // r) * (w // r), r * r, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition` -> (B, H, W, C)."""
    r = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // r) * (w // r))
    x = windows.reshape(b, h // r, w // r, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=32)
def shifted_window_attn_mask(h: int, w: int, window_size: int, shift_size: int,
                             device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Additive SW-MSA mask (nW, r*r, r*r) of 0 and -100 (not -inf): tokens
    that wrapped around under the cyclic shift do not attend across region
    boundaries. Cached per shape and device; callers must not modify it."""
    r = window_size
    if h % r or w % r:
        raise ValueError(f"{h}x{w} is not a multiple of window {r}")

    def labels(size: int) -> torch.Tensor:
        i = torch.arange(size, device=device)
        return (i >= size - r).long() + (i >= size - shift_size).long()

    lab = labels(h)[:, None] * 3 + labels(w)[None, :]
    lab = lab.reshape(h // r, r, w // r, r).permute(0, 2, 1, 3).reshape(-1, r * r)
    diff = lab[:, :, None] - lab[:, None, :]
    return torch.where(diff != 0, -100.0, 0.0).float()


def cyclic_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """torch.roll(x, (-shift, -shift), dims=(1, 2))."""
    return x if shift == 0 else torch.roll(x, (-shift, -shift), dims=(1, 2))


def cyclic_unshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    return x if shift == 0 else torch.roll(x, (shift, shift), dims=(1, 2))
