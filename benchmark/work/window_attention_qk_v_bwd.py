"""``mde::window_attention_qk_v_bwd`` (K1's backward over a fused qk
projection and a separate v): inputs qk (BW, N, 2C), v (BW, N, C), dout,
bias, mask. Operations 10 BW N^2 C; bytes: the five inputs once, dqk, dv
and the f32 dbias once (``chip_smoke.py``'s ``window_qk_v_bwd_phase``,
which leaves the bias and mask reads out, with them, as the fused entry's
count has them)."""

from __future__ import annotations

from .ops import nbytes

KERNEL = r"\bwindow_attention_bwd_(mma_|wide_|lean_)?kernel\b"


def cost(dims, types):
    bw, n, c = dims[1]
    read = sum(nbytes(d, t) for d, t in zip(dims[:5], types[:5]))
    written = nbytes(dims[0], types[0]) + nbytes(dims[1], types[1]) + nbytes(dims[3], types[3])
    return read + written, 10 * bw * n * n * c
