"""``mde::window_attention_bwd`` (kernel K1's backward over the fused qkv
projection): inputs qkv (BW, N, 3C), dout (BW, N, C), bias (heads, N, N)
f32 or absent, mask (nW, N, N) f32 or absent. Operations: the five
products, 10 BW N^2 C. Bytes: the four inputs read once, dqkv (qkv's
shape) and the f32 dbias written once (``chip_smoke.py``'s
``window_bwd_phase``)."""

from __future__ import annotations

from .ops import nbytes

# the backward kernels' names in a device trace
KERNEL = r"\bwindow_attention_bwd_(mma_|wide_|lean_)?kernel\b"


def cost(dims, types):
    bw, n, c3 = dims[0]
    read = sum(nbytes(d, t) for d, t in zip(dims[:4], types[:4]))
    written = nbytes(dims[0], types[0]) + nbytes(dims[2], types[2])
    return read + written, 10 * bw * n * n * (c3 // 3)
