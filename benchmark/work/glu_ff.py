"""``mde::glu_ff`` (K4, the fused GLU feed-forward): ab (B, H, W, 2C),
taps (k, k, C), the folded BatchNorm's scale and shift (C,) f32; output
(B, H, W, C). Operations: 2 k^2 an output for the taps and 14 for the
gate, the affine and the erf GELU; bytes: the inputs once, the output
once."""

from __future__ import annotations

import math

from .ops import nbytes

KERNEL = r"\bglu_ff_(tiled_)?kernel\b"


def cost(dims, types):
    ab, w = dims[0], dims[1]
    out_dims = list(ab[:-1]) + [ab[-1] // 2]
    read = sum(nbytes(d, t) for d, t in zip(dims[:4], types[:4]))
    return read + nbytes(out_dims, types[0]), (2 * w[0] * w[1] + 14) * math.prod(out_dims)
