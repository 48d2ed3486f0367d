"""``mde::ordered_attention`` (K2's forward): inputs q, k, v (BW, N, C),
depth indices (BW, N) int32 and the (2E - 1, heads) f32 table, both
absent without a depth bias. Operations 4 BW N^2 C (the bias is a
gather); bytes: the five inputs once, the (BW, N, C) output once."""

from __future__ import annotations

from .ops import nbytes

KERNEL = r"\bordered_attention_(mma|f32)_kernel\b"


def cost(dims, types):
    bw, n, c = dims[0]
    read = sum(nbytes(d, t) for d, t in zip(dims[:5], types[:5]))
    return read + nbytes([bw, n, c], types[0]), 4 * bw * n * n * c
