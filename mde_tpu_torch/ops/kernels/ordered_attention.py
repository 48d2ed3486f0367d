"""K2: ordered depth-bias window attention, forward.

Port of ``fused_ordered_window_attention``
(``mde_tpu/ops/pallas/ordered_attention.py:513``). The CUDA kernel is
``csrc/ordered_attention.cu``; ``plain_ordered_attention`` is the same
function in PyTorch, mirroring ``xla_ordered_attention`` (:83).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check, check_head_smem, dtype_code, is_plain, launch, ptr


def plain_ordered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            idx: torch.Tensor, table: Optional[torch.Tensor],
                            num_heads: int, scale: float, num_emb: int) -> torch.Tensor:
    """softmax(q . k^T * scale + T[idx_q - idx_k + E - 1, h]) . v over
    (B*nW, N, C) windows; ``table=None`` gives plain window MHA.

    idx: (B*nW, N) integer depth indices in [0, num_emb); table:
    (2*num_emb - 1, heads). The logits are scaled in f32, after the
    product, as in the JAX version."""
    bw, n, c = q.shape
    hd = c // num_heads
    qh = q.reshape(bw, n, num_heads, hd)
    kh = k.reshape(bw, n, num_heads, hd)
    vh = v.reshape(bw, n, num_heads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() * scale
    if table is not None:
        rel = idx[:, :, None].long() - idx[:, None, :].long() + (num_emb - 1)
        attn = attn + table.t()[:, rel].permute(1, 0, 2, 3).float()
    attn = attn.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(bw, n, c)


def ordered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      idx: torch.Tensor, table: Optional[torch.Tensor],
                      num_heads: int, scale: float, num_emb: int) -> torch.Tensor:
    """Ordered window MHA: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (which clamps indices into [0, num_emb))."""
    if is_plain(q):
        return plain_ordered_attention(q, k, v, idx, table, num_heads, scale, num_emb)
    bw, n, c = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(name, t, (bw, n, c), q.dtype, q.device)
    if c % num_heads:
        raise ValueError(f"ordered_attention: {c} channels do not split into "
                         f"{num_heads} heads")
    extra = 0
    if table is not None:
        check("idx", idx, (bw, n), torch.int32, q.device)
        check("table", table, (2 * num_emb - 1, num_heads), torch.float32, q.device)
        extra = 2 * num_emb - 1 + n
    check_head_smem("ordered_attention", n, c // num_heads, extra)
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    launch("ordered_attention", "mde_ordered_attention", q.device,
           ptr(q), ptr(k), ptr(v), None if table is None else ptr(idx), ptr(table),
           ptr(out), bw, n, c, num_heads, num_emb, float(scale), dtype_code(q))
    return out
