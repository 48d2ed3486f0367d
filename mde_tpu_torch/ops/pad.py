"""Spatial padding of NHWC tensors (``mde_tpu/ops/pad.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad2d(x: torch.Tensor, pad_t: int, pad_b: int, pad_l: int, pad_r: int,
          mode: str = "edge") -> torch.Tensor:
    """Pad the H and W dims of NHWC ``x``. ``edge`` repeats the border
    (torch's ``replicate``); ``zeros`` pads with zeros."""
    if pad_t == pad_b == pad_l == pad_r == 0:
        return x
    if mode == "zeros":
        return F.pad(x, (0, 0, pad_l, pad_r, pad_t, pad_b))
    if mode != "edge":
        raise ValueError(f"Unsupported padding mode {mode!r}")
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(-pad_t, h + pad_b, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-pad_l, w + pad_r, device=x.device).clamp_(0, w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def pad_to_multiple(x: torch.Tensor, multiple: int, mode: str = "edge") -> torch.Tensor:
    """Pad H and W (bottom and right) up to the next multiple of ``multiple``."""
    h, w = x.shape[1], x.shape[2]
    return pad2d(x, 0, (-h) % multiple, 0, (-w) % multiple, mode=mode)
