"""``mde::window_attention_qk_v`` (K1's forward over a fused qk projection
and a separate v): inputs qk (BW, N, 2C), v (BW, N, C), bias, mask.
Operations 4 BW N^2 C; bytes: the four inputs once, the output once."""

from __future__ import annotations

from .ops import nbytes

KERNEL = r"\bwindow_attention_(mma_|wide_)?kernel\b"


def cost(dims, types):
    bw, n, c = dims[1]
    read = sum(nbytes(d, t) for d, t in zip(dims[:4], types[:4]))
    return read + nbytes([bw, n, c], types[1]), 4 * bw * n * n * c
