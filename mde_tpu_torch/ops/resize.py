"""Bilinear and nearest resizes and adaptive average pooling of NHWC
tensors (``mde_tpu/ops/resize.py``), with ``F.interpolate``'s and
``nn.AdaptiveAvgPool2d``'s semantics: the bilinear resize and the pooling
computed in f32 and cast back, the nearest resize a gather."""

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


def _nearest_rows(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The source index of each output row of torch's ``nearest``:
    floor(i * (in / out)), the ratio and the product in f32, clipped to the
    input (``_nearest_matrix``, ``mde_tpu/ops/resize.py:52-58``)."""
    ratio = torch.tensor(in_size / out_size, dtype=torch.float32)
    src = torch.floor(torch.arange(out_size, dtype=torch.float32) * ratio)
    return src.long().clamp_(0, in_size - 1).to(device)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize matching ``F.interpolate(..., mode='nearest')``:
    a gather of rows, then of columns, in x's dtype."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[1], x.shape[2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    x = x.index_select(1, _nearest_rows(in_h, out_h, x.device))
    return x.index_select(2, _nearest_rows(in_w, out_w, x.device))


def _adaptive_avg_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(out_size, in_size) region-mean matrix of ``nn.AdaptiveAvgPool2d``:
    row i averages [floor(i * in / out), ceil((i + 1) * in / out))."""
    i = torch.arange(out_size, device=device)
    start = (i * in_size) // out_size
    end = ((i + 1) * in_size + out_size - 1) // out_size
    cols = torch.arange(in_size, device=device)[None, :]
    inside = (cols >= start[:, None]) & (cols < end[:, None])
    return inside.float() / (end - start)[:, None].float()


def adaptive_avg_pool2d(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC ``nn.AdaptiveAvgPool2d(size)``, as the JAX version computes it:
    two region-mean matrices applied in f32 (H first), cast back."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[1], x.shape[2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    y = torch.einsum("iH,bHWc->biWc", _adaptive_avg_matrix(in_h, out_h, x.device), x.float())
    y = torch.einsum("jW,biWc->bijc", _adaptive_avg_matrix(in_w, out_w, x.device), y)
    return y.to(x.dtype)
