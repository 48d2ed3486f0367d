"""K3: depthwise 'same' 2-D convolution with replicate padding, NHWC, forward.

Port of ``fused_depthwise_conv2d`` (``mde_tpu/ops/pallas/depthwise.py:521``).
The CUDA kernel is ``csrc/depthwise.cu``; ``plain_depthwise_conv2d`` is the
same function in PyTorch, mirroring ``xla_depthwise_conv2d`` (:38).
"""

from __future__ import annotations

import torch

from ..pad import pad2d
from . import check, dtype_code, is_plain, launch, ptr


def plain_depthwise_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C); w: (kh, kw, C). Replicate pad, 'same' output.

    Accumulates in x's dtype, tap by tap (i outer, j inner), as the JAX
    version does; the CUDA kernel accumulates in f32."""
    kh, kw, _ = w.shape
    h, wd = x.shape[1], x.shape[2]
    xp = pad2d(x, kh // 2, kh // 2, kw // 2, kw // 2, mode="edge")
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            out = out + xp[:, i:i + h, j:j + wd, :] * w[i, j]
    return out


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise conv: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors. w must have x's dtype and odd kernel sides."""
    if is_plain(x):
        return plain_depthwise_conv2d(x, w)
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"depthwise_conv2d: x (B, H, W, C) and w (kh, kw, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"depthwise_conv2d: kernel {kh}x{kw} must have odd sides")
    check("x", x, (b, h, wd, c), x.dtype, x.device)
    check("w", w, (kh, kw, c), x.dtype, x.device)
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    vec16 = int(c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (x, w, out)))
    launch("depthwise_conv2d", "mde_depthwise_conv2d", x.device,
           ptr(x), ptr(w), ptr(out), b, h, wd, c, kh, kw, vec16, dtype_code(x))
    return out
