"""K3: depthwise 'same' 2-D convolution with replicate padding, NHWC, with
its backward.

Port of ``fused_depthwise_conv2d`` (``mde_tpu/ops/pallas/depthwise.py:521``)
and its hand-written backward pair: ``_dxdw_pallas`` (:322, both gradients
in one pass) and ``_dw_pallas`` (:189, the weight gradient alone). The CUDA
kernels are ``csrc/depthwise.cu``, ``csrc/depthwise_dxdw.cu`` and
``csrc/depthwise_dw.cu``, joined by one ``torch.autograd.Function``;
``plain_depthwise_conv2d`` mirrors ``xla_depthwise_conv2d`` (:38), and
``plain_depthwise_dxdw`` and ``plain_depthwise_dw`` the backward bodies.

The backward takes dxdw where the TPU's default pairs ``_dw_pallas`` with an
XLA grouped conv for dx (:480-489): on the card cuDNN's grouped conv is the
slow half of such a pair (PERF.md), and dxdw computes both gradients in one
pass (JAX's ``MDE_DWCONV_BWD=fused``).

Each kernel has two bodies, chosen by shape in its C entry point: a tiled
body (``csrc/depthwise_tile.cuh``; the backward's sweep and dw role in
``csrc/depthwise_bwd_tile.cuh``, shared by dxdw and dw, which give the same
dw bits) for square 3x3, 5x5 and 7x7 kernels on C in whole 16-byte vectors
with 16-byte aligned tensors, and for the rest (odd non-square kernels,
other C, misaligned views) the forward's column body and the backward's
gather body (``csrc/depthwise_bwd.cuh``). Both are kernels; nothing falls
back from one to the other. The forward is the operator
``torch.ops.mde.depthwise_conv2d`` (``torch.library.custom_op``); the
backward entries are called through ``ctypes``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..pad import pad2d
from . import check, dtype_code, is_plain, launch, library, ptr

# the backward kernels are compiled for these square kernel sizes
BWD_KERNEL_SIZES = (3, 5, 7)


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


def plain_depthwise_dw(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """dL/dw (kh, kw, C) f32 of the replicate-pad depthwise conv, from the
    unpadded input x and the output gradient g (both (B, H, W, C)):
    dw[i, j, c] = sum_{b, p, q} xp[b, p+i, q+j, c] * g[b, p, q, c], products
    and sums in f32, as ``_dw_kernel`` takes them."""
    h, wd = x.shape[1], x.shape[2]
    xp = pad2d(x.float(), kh // 2, kh // 2, kw // 2, kw // 2, mode="edge")
    g32 = g.float()
    return torch.stack([torch.stack([(xp[:, i:i + h, j:j + wd, :] * g32).sum(dim=(0, 1, 2))
                                     for j in range(kw)]) for i in range(kh)])


def plain_depthwise_dxdw(x: torch.Tensor, g: torch.Tensor,
                         w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw f32) of the replicate-pad depthwise conv, as
    ``_dxdw_kernel`` computes them: dxp, the gradient with respect to the
    padded input, is the 'full' correlation of g with the flipped taps,
    accumulated in f32; the replicate pad's transpose then folds its edge
    rows and columns back onto the border, and dx is cast once."""
    kh, kw, _ = w.shape
    b, h, wd, c = x.shape
    ph, pw = kh // 2, kw // 2
    g32 = g.float()
    w32 = w.float()
    gp = torch.zeros((b, h + 2 * (kh - 1), wd + 2 * (kw - 1), c), dtype=torch.float32,
                     device=g.device)
    gp[:, kh - 1:kh - 1 + h, kw - 1:kw - 1 + wd] = g32
    rows, cols = h + kh - 1, wd + kw - 1
    dxp = torch.zeros((b, rows, cols, c), dtype=torch.float32, device=g.device)
    for i in range(kh):
        for j in range(kw):
            dxp = dxp + gp[:, i:i + rows, j:j + cols] * w32[kh - 1 - i, kw - 1 - j]
    # transpose of pad2d(edge): padded row r came from row clamp(r - ph)
    row_src = (torch.arange(rows, device=g.device) - ph).clamp_(0, h - 1)
    col_src = (torch.arange(cols, device=g.device) - pw).clamp_(0, wd - 1)
    dx = torch.zeros((b, h, cols, c), dtype=torch.float32, device=g.device)
    dx = dx.index_add_(1, row_src, dxp)
    dx = torch.zeros((b, h, wd, c), dtype=torch.float32, device=g.device).index_add_(
        2, col_src, dx)
    return dx.to(x.dtype), plain_depthwise_dw(x, g, kh, kw)


def _check_backward(x, g, w) -> int:
    """Raise on what the backward kernels do not take; return vec2."""
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    if kh != kw or kh not in BWD_KERNEL_SIZES:
        raise ValueError(f"depthwise_conv2d backward: kernel {kh}x{kw}; the CUDA kernels "
                         f"take square sizes {BWD_KERNEL_SIZES}")
    check("x", x, (b, h, wd, c), x.dtype, x.device)
    check("g", g, (b, h, wd, c), x.dtype, x.device)
    check("w", w, (kh, kw, c), x.dtype, x.device)
    align = 2 * x.element_size()
    return int(c % 2 == 0 and all(t.data_ptr() % align == 0 for t in (x, g, w)))


def _partials(x: torch.Tensor, k: int) -> torch.Tensor:
    """Scratch for the backward kernels' per-(image, band or strip) sums of
    dw, as many as the kernels' sources ask for."""
    b, h, wd, c = x.shape
    return torch.empty((library().mde_depthwise_bwd_parts(b, h, wd, k), k, k, c),
                       dtype=torch.float32, device=x.device)


def depthwise_dxdw(x: torch.Tensor, g: torch.Tensor,
                   w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw f32) for the output gradient g: the plain
    version for CPU tensors, the dxdw kernel for CUDA tensors."""
    if is_plain(x):
        return plain_depthwise_dxdw(x, g, w)
    vec2 = _check_backward(x, g, w)
    b, h, wd, c = x.shape
    k = w.shape[0]
    dx, part = torch.empty_like(x), _partials(x, k)
    dw = torch.empty((k, k, c), dtype=torch.float32, device=x.device)
    launch("depthwise_conv2d_dxdw", "mde_depthwise_conv2d_dxdw", x.device, ptr(x), ptr(g),
           ptr(w), ptr(dx), ptr(part), ptr(dw), b, h, wd, c, k, vec2, dtype_code(x))
    return dx, dw


def depthwise_dw(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dw f32 (the shape of w) for the output gradient g: the plain version
    for CPU tensors, the dw kernel for CUDA tensors."""
    kh, kw, _ = w.shape
    if is_plain(x):
        return plain_depthwise_dw(x, g, kh, kw)
    vec2 = _check_backward(x, g, w)
    b, h, wd, c = x.shape
    dw = torch.empty((kh, kw, c), dtype=torch.float32, device=x.device)
    part = _partials(x, kh)
    launch("depthwise_conv2d_dw", "mde_depthwise_conv2d_dw", x.device, ptr(x), ptr(g),
           ptr(part), ptr(dw), b, h, wd, c, kh, vec2, dtype_code(x))
    return dw


def direct_depthwise_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors, checked and launched without the
    operator's dispatch."""
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


@torch.library.custom_op("mde::depthwise_conv2d", mutates_args=())
def depthwise_conv2d_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3's forward as an operator of its own (``torch.ops.mde.depthwise_conv2d``),
    so that ``torch.export`` records it as one node: the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if is_plain(x):
        return plain_depthwise_conv2d(x, w)
    return direct_depthwise_conv2d(x, w)


@depthwise_conv2d_op.register_fake
def _(x, w):
    is_plain(x)  # tracing takes CPU and CUDA tensors; the rest raise
    return torch.empty_like(x)


class DepthwiseConv2dFn(torch.autograd.Function):
    """K3 forward (``torch.ops.mde.depthwise_conv2d``); backward by dxdw
    when x needs a gradient (always in the train step), by dw alone when
    only w does. dw is computed in f32 and cast to w's dtype, as
    ``mde_tpu/ops/pallas/depthwise.py:486-488`` does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return depthwise_conv2d_op(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        g = g.contiguous()
        if need_x:
            dx, dw = depthwise_dxdw(x, g, w)
        else:
            dx, dw = None, depthwise_dw(x, g, w)
        return dx, dw.to(w.dtype) if need_w else None


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise conv, differentiable in x and w: the plain versions for CPU
    tensors, the CUDA kernels for CUDA tensors. w must have x's dtype and
    odd kernel sides (square 3, 5 or 7 for the backward kernels)."""
    return DepthwiseConv2dFn.apply(x, w)
