"""``mde::depthwise_conv2d_dw`` (K3's weight gradient alone): x and g
(B, H, W, C), taps w (k, k, C), of which only the shape is used.
Operations 2 k^2 an element of x; bytes: x and g once, the f32 dw once
(``chip_smoke.py``'s ``depthwise_bwd_phase``). Each call launches the pass
and the reduction of its partial sums, as ``depthwise_conv2d_dxdw``."""

from __future__ import annotations

import math

from .ops import nbytes

KERNEL = r"\bdepthwise_dw_tiled_kernel\b|\bdepthwise_bwd_kernel<[^>]*\bfalse>"
ALSO = r"\bdepthwise_sum_partials\b"


def cost(dims, types):
    x, w = dims[0], dims[2]
    read = nbytes(x, types[0]) + nbytes(dims[1], types[1])
    return read + nbytes(w, "float"), 2 * w[0] * w[1] * math.prod(x)
