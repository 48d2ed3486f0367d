"""K1: window multi-head attention (W-MSA / SW-MSA), forward.

Port of ``fused_window_attention`` (``mde_tpu/ops/pallas/window_attention.py:352``).
The CUDA kernel is ``csrc/window_attention.cu``; ``plain_window_attention``
is the same function in PyTorch, mirroring ``xla_window_attention`` (:77).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check, check_head_smem, dtype_code, is_plain, launch, ptr


def plain_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                           num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q*scale . k^T + bias + mask) . v over (B*nW, N, C) windows.

    bias: (heads, N, N) f32 or None; mask: (nW, N, N) 0/-100 or None, where
    window ``w`` takes ``mask[w % nW]``. q is scaled in its own dtype and the
    probabilities are cast back to it, as in the JAX version."""
    bw, n, c = q.shape
    hd = c // num_heads
    qh = q.reshape(bw, n, num_heads, hd)
    kh = k.reshape(bw, n, num_heads, hd)
    vh = v.reshape(bw, n, num_heads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", qh * torch.tensor(scale, dtype=q.dtype), kh)
    attn = attn.float()
    if bias is not None:
        attn = attn + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(bw // nw, nw, num_heads, n, n) + mask.float()[None, :, None]
        attn = attn.reshape(bw, num_heads, n, n)
    attn = attn.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(bw, n, c)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                     num_heads: int, scale: float) -> torch.Tensor:
    """Window MHA: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors. q, k and v may be views into one fused qkv projection:
    the kernel takes rows a common stride apart, with unit channel stride."""
    if is_plain(q):
        return plain_window_attention(q, k, v, bias, mask, num_heads, scale)
    bw, n, c = q.shape
    ld = q.stride(1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (tuple(t.shape) != (bw, n, c) or t.dtype != q.dtype or t.device != q.device
                or t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != n * ld):
            raise ValueError(f"window_attention: {name} must be ({bw}, {n}, {c}) "
                             f"{q.dtype} on {q.device} with unit channel stride and "
                             f"rows {ld} apart, like q")
    if c % num_heads:
        raise ValueError(f"window_attention: {c} channels do not split into "
                         f"{num_heads} heads")
    check_head_smem("window_attention", n, c // num_heads)
    if bias is not None:
        check("bias", bias, (num_heads, n, n), torch.float32, q.device)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check("mask", mask, (nw, n, n), torch.float32, q.device)
        if bw % nw:
            raise ValueError(f"window_attention: {bw} windows are not a multiple of "
                             f"the mask's {nw}")
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    launch("window_attention", "mde_window_attention", q.device,
           ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(out),
           bw, n, c, num_heads, ld, nw, float(scale), dtype_code(q))
    return out
