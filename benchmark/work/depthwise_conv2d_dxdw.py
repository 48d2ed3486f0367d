"""``mde::depthwise_conv2d_dxdw`` (K3's backward pair): x and the output
gradient g (B, H, W, C), taps w (k, k, C). Operations 4 k^2 an element of
x (the multiply-adds of dx and dw); bytes: x, g and w once, dx and the
f32 dw once (``chip_smoke.py``'s ``depthwise_bwd_phase``). Each call
launches the pass (``KERNEL``) and a reduction of its partial sums of dw
(``ALSO``), whose time is the call's too."""

from __future__ import annotations

import math

from .ops import nbytes

KERNEL = r"\bdepthwise_dxdw_tiled_kernel\b|\bdepthwise_bwd_kernel<[^>]*\btrue>"
ALSO = r"\bdepthwise_sum_partials\b"


def cost(dims, types):
    x, w = dims[0], dims[2]
    read = nbytes(x, types[0]) + nbytes(dims[1], types[1]) + nbytes(w, types[2])
    written = nbytes(x, types[0]) + nbytes(w, "float")
    return read + written, 4 * w[0] * w[1] * math.prod(x)
