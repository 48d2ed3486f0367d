"""``mde::window_attention`` (kernel K1's forward over the fused qkv
projection): inputs qkv (BW, N, 3C), bias (heads, N, N) f32, mask
(nW, N, N) f32 or absent. Operations: the two products, 4 BW N^2 C.
Bytes: qkv, bias and mask read once, the (BW, N, C) output written once."""

from __future__ import annotations

from .ops import nbytes

# the forward kernels' names in a device trace
KERNEL = r"\bwindow_attention_(mma_|wide_)?kernel\b"


def cost(dims, types):
    bw, n, c3 = dims[0]
    c = c3 // 3
    read = sum(nbytes(d, t) for d, t in zip(dims[:3], types[:3]))
    out = nbytes([bw, n, c], types[0])
    return read + out, 4 * bw * n * n * c
