"""``mde::depthwise_conv2d`` (K3's forward): x (B, H, W, C) and taps
(k, k, C), replicate padding, output the size of x. Operations 2 k^2 a
output; bytes: x and taps once, the output once."""

from __future__ import annotations

import math

from .ops import nbytes

KERNEL = r"\bdepthwise_(tiled_)?kernel\b"


def cost(dims, types):
    x, w = dims[0], dims[1]
    out = math.prod(x)
    read = nbytes(x, types[0]) + nbytes(w, types[1])
    return read + nbytes(x, types[0]), 2 * w[0] * w[1] * out
