"""K1: window multi-head attention (W-MSA / SW-MSA), forward and backward.

Port of ``fused_window_attention`` (``mde_tpu/ops/pallas/window_attention.py:352``)
and its ``custom_vjp``. The CUDA kernels are ``csrc/window_attention.cu`` and
``csrc/window_attention_bwd.cu``, joined by one ``torch.autograd.Function``;
``plain_window_attention`` mirrors ``xla_window_attention`` (:77) and
``plain_window_attention_bwd`` the backward kernel body (``_bwd_kernel``,
:180). bf16 windows of up to 128 tokens at head dims that are multiples of
8 up to 128 run on the tensor cores; f32, and bf16 beyond those shapes, on
the CUDA cores (the rule ``mma_shape`` in ``csrc/attention_mma.cuh``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import check, check_smem, dtype_code, is_plain, launch, library, ptr


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


def plain_window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               dout: torch.Tensor, bias: Optional[torch.Tensor],
                               mask: Optional[torch.Tensor], num_heads: int, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                          Optional[torch.Tensor]]:
    """(dq, dk, dv, dbias) of :func:`plain_window_attention`, step by step as
    the JAX backward kernel computes them: q scaled in its dtype, products
    in f32, P and dS cast to the input dtype before the dq, dk and dv
    products, dq scaled in f32, dbias (f32) the sum of dS over windows.
    dbias is None without a bias."""
    bw, n, c = q.shape
    hd = c // num_heads
    dt = q.dtype
    qs = q * torch.tensor(scale, dtype=dt)
    qh, kh, vh, doh = (t.reshape(bw, n, num_heads, hd).float() for t in (qs, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if bias is not None:
        s = s + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, num_heads, n, n) + mask.float()[None, :, None]
             ).reshape(bw, num_heads, n, n)
    p = s.softmax(dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    p_lo = p.to(dout.dtype).float()
    ds_lo = ds.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_lo, doh)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, kh) * torch.tensor(scale, dtype=torch.float32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, qh)
    dbias = ds.sum(dim=0) if bias is not None else None
    return (dq.to(dt).reshape(bw, n, c), dk.to(dt).reshape(bw, n, c),
            dv.to(dt).reshape(bw, n, c), dbias)


def _check_inputs(qkv, bias, mask, num_heads, dout=None) -> int:
    """Raise on what the forward (or, given ``dout``, the backward) kernel
    does not take: bf16 tensors that do not start on 16 bytes (the
    tensor-core kernels copy 16-byte pieces) and blocks beyond a block's
    shared memory (as the kernel's source counts it). Return the mask's nW
    (0 for no mask)."""
    bw, n, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"window_attention: {c3} fused channels do not split into q, k, v "
                         f"of {num_heads} heads")
    c = c3 // 3
    name = "window_attention" if dout is None else "window_attention_bwd"
    tensors = (("qkv", qkv),) + (() if dout is None else (("dout", dout),))
    check("qkv", qkv, (bw, n, c3), qkv.dtype, qkv.device)
    if dout is not None:
        check("dout", dout, (bw, n, c), qkv.dtype, qkv.device)
    code = dtype_code(qkv)
    if qkv.dtype == torch.bfloat16:
        for tname, t in tensors:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {tname} does not start on a 16-byte boundary")
    if dout is None:
        need = library().mde_window_attention_smem(n, c, num_heads, code)
    else:
        need = library().mde_window_attention_bwd_smem(n, c, num_heads, int(bias is not None),
                                                       code)
    check_smem(name, n, c // num_heads, need)
    if bias is not None:
        check("bias", bias, (num_heads, n, n), torch.float32, qkv.device)
    if mask is None:
        return 0
    nw = mask.shape[0]
    check("mask", mask, (nw, n, n), torch.float32, qkv.device)
    if bw % nw:
        raise ValueError(f"window_attention: {bw} windows are not a multiple of the "
                         f"mask's {nw}")
    return nw


def window_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                         bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                         num_heads: int, scale: float
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dqkv in qkv's fused layout, dbias f32 or None without a bias) for
    the output gradient dout: the plain version for CPU tensors, the
    backward kernel for CUDA tensors."""
    c = qkv.shape[-1] // 3
    if is_plain(qkv):
        dq, dk, dv, dbias = plain_window_attention_bwd(
            qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], dout, bias, mask, num_heads,
            scale)
        return torch.cat([dq, dk, dv], dim=-1), dbias
    nw = _check_inputs(qkv, bias, mask, num_heads, dout)
    bw, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    dbias = (None if bias is None else
             torch.zeros((num_heads, n, n), dtype=torch.float32, device=qkv.device))
    launch("window_attention_bwd", "mde_window_attention_bwd", qkv.device,
           ptr(qkv), ptr(dout), ptr(bias), ptr(mask), ptr(dqkv), ptr(dbias),
           bw, n, c, num_heads, nw, float(scale), dtype_code(qkv))
    return dqkv, dbias


class WindowAttentionFn(torch.autograd.Function):
    """K1 forward and backward over the fused (B*nW, N, 3C) qkv projection;
    the gradient comes back in the same fused layout, so autograd adds no
    slice copies. The mask is a constant and gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, bias, mask)
        c = qkv.shape[-1] // 3
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        if is_plain(qkv):
            return plain_window_attention(q, k, v, bias, mask, num_heads, scale)
        nw = _check_inputs(qkv, bias, mask, num_heads)
        bw, n, _ = qkv.shape
        out = torch.empty((bw, n, c), dtype=qkv.dtype, device=qkv.device)
        launch("window_attention", "mde_window_attention", qkv.device,
               ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(out),
               bw, n, c, num_heads, 3 * c, nw, float(scale), dtype_code(qkv))
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        # autograd may hand over a view (a slice of a larger gradient): the
        # kernel takes a contiguous one that starts on 16 bytes
        if not dout.is_contiguous() or dout.data_ptr() % 16:
            dout = dout.clone(memory_format=torch.contiguous_format)
        dqkv, dbias = window_attention_bwd(qkv, dout, bias, mask, ctx.num_heads, ctx.scale)
        return dqkv, dbias if ctx.needs_input_grad[1] else None, None, None, None


def window_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], num_heads: int,
                     scale: float) -> torch.Tensor:
    """Window MHA over the fused projection ``qkv`` (B*nW, N, 3C) = q | k | v
    along the last dim -> (B*nW, N, C), differentiable in qkv and bias: the
    plain versions for CPU tensors, the CUDA kernels for CUDA tensors (a
    bf16 ``qkv`` must start on 16 bytes)."""
    return WindowAttentionFn.apply(qkv, bias, mask, num_heads, scale)
