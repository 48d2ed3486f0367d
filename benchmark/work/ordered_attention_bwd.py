"""``mde::ordered_attention_bwd`` (K2's backward): inputs q, k, v, dout
(BW, N, C), depth indices (BW, N) int32 and the (2E - 1, heads) f32 table,
both unread without a table. Operations 10 BW N^2 C; bytes: the inputs
once, dq, dk, dv and the f32 dtable once (``chip_smoke.py``'s
``ordered_bwd_phase``)."""

from __future__ import annotations

from .ops import nbytes

KERNEL = r"\bordered_attention_bwd_(mma|f32)_kernel\b"


def cost(dims, types):
    bw, n, c = dims[0]
    table = bool(dims[5])
    read = sum(nbytes(d, t) for d, t in zip(dims[:4], types[:4]))
    if table:
        read += nbytes(dims[4], types[4]) + nbytes(dims[5], types[5])
    written = 3 * nbytes(dims[0], types[0]) + (nbytes(dims[5], types[5]) if table else 0)
    return read + written, 10 * bw * n * n * c
