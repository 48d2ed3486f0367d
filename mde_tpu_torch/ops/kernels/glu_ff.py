"""K4: the fused eval feed-forward middle, GLU gate + depthwise conv +
folded BatchNorm + exact-erf GELU, NHWC.

Port of ``fused_glu_dwconv_bn_gelu`` (``mde_tpu/ops/pallas/glu_ff.py:245``)
and its ``custom_vjp``. The CUDA kernel is ``csrc/glu_ff.cu``;
``plain_glu_ff`` mirrors ``xla_glu_dwconv_bn_gelu`` (:45). The JAX package
has no backward kernel: its backward recomputes the composite with autograd
(``_fused_bwd``, :235), and so does this one, through the port's K3
(``depthwise_conv2d``: on the card K3's forward and dxdw kernels).

The JAX wrapper sends ``C > 128 and C % 128 != 0`` to XLA (:254), a guard of
the TPU's tiling; the CUDA kernel takes any C. Square 3x3, 5x5 and 7x7
kernels on C in whole 16-byte vectors with 16-byte aligned tensors take its
tiled body (K3's tile with the gate staged once), the rest its column body;
the two give the same bits. The kernel is the operator
``torch.ops.mde.glu_ff`` (``torch.library.custom_op``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check, dtype_code, is_plain, launch, ptr
from .depthwise import depthwise_conv2d, plain_depthwise_conv2d


def _gate(ab: torch.Tensor) -> torch.Tensor:
    a, b = ab.chunk(2, dim=-1)
    return (a * torch.sigmoid(b)).contiguous()


def _epilogue(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor, dtype) -> torch.Tensor:
    """Folded BatchNorm and exact-erf GELU in f32, one cast to ``dtype``."""
    return F.gelu(y.float() * s + t, approximate="none").to(dtype)


def plain_glu_ff(ab: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """ab: (B, H, W, 2C), a | b along the last dim; w: (kh, kw, C) in ab's
    dtype; s, t: (C,) f32 -> gelu_erf(dwconv(a * sigmoid(b)) * s + t) in
    ab's dtype. The gate and the conv (plain K3, tap by tap) run in ab's
    dtype, the affine and GELU in f32, as the JAX version does."""
    return _epilogue(plain_depthwise_conv2d(_gate(ab), w), s, t, ab.dtype)


def _composite(ab, w, s, t):
    """The backward's recompute: the plain version's steps, with the conv
    through K3's autograd Function."""
    return _epilogue(depthwise_conv2d(_gate(ab), w), s, t, ab.dtype)


def direct_glu_ff(ab: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, checked and launched without the
    operator's dispatch."""
    if ab.dim() != 4 or w.dim() != 3 or ab.shape[-1] % 2:
        raise ValueError(f"glu_ff: ab (B, H, W, 2C) and w (kh, kw, C), got "
                         f"{tuple(ab.shape)} and {tuple(w.shape)}")
    b, h, wd, c2 = ab.shape
    c = c2 // 2
    kh, kw, _ = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"glu_ff: kernel {kh}x{kw} must have odd sides")
    check("ab", ab, (b, h, wd, c2), ab.dtype, ab.device)
    check("w", w, (kh, kw, c), ab.dtype, ab.device)
    check("s", s, (c,), torch.float32, ab.device)
    check("t", t, (c,), torch.float32, ab.device)
    out = torch.empty((b, h, wd, c), dtype=ab.dtype, device=ab.device)
    vec = 16 // ab.element_size()
    vec16 = int(c % vec == 0 and all(x.data_ptr() % 16 == 0 for x in (ab, w, out)))
    launch("glu_ff", "mde_glu_ff", ab.device, ptr(ab), ptr(w), ptr(s), ptr(t), ptr(out),
           b, h, wd, c, kh, kw, vec16, dtype_code(ab))
    return out


@torch.library.custom_op("mde::glu_ff", mutates_args=())
def glu_ff_op(ab: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """K4 as an operator of its own (``torch.ops.mde.glu_ff``), so that
    ``torch.export`` records it as one node: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if is_plain(ab):
        return plain_glu_ff(ab, w, s, t)
    return direct_glu_ff(ab, w, s, t)


@glu_ff_op.register_fake
def _(ab, w, s, t):
    is_plain(ab)  # tracing takes CPU and CUDA tensors; the rest raise
    return ab.new_empty((*ab.shape[:-1], ab.shape[-1] // 2))


class GluFFFn(torch.autograd.Function):
    """K4 forward (``torch.ops.mde.glu_ff``); backward by autograd through
    the recomputed composite, with gradients for ab, w, s and t."""

    @staticmethod
    def forward(ctx, ab, w, s, t):
        ctx.save_for_backward(ab, w, s, t)
        return glu_ff_op(ab, w, s, t)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(n) for x, n in zip(saved, need)]
            wanted = [x for x, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(_composite(*inputs), wanted, g))
        return tuple(next(grads) if n else None for n in need)


def glu_ff(ab: torch.Tensor, w: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """gelu_erf(dwconv(a * sigmoid(b)) * s + t) in one pass over ab,
    differentiable in all four: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    return GluFFFn.apply(ab, w, s, t)
