"""K5: the KSA decoder's kernel-window (channel) cross attention, forward
and backward.

Port of ``fused_channel_attention`` (``mde_tpu/ops/pallas/channel_attention.py:183``)
and its ``custom_vjp``. The CUDA kernels are ``csrc/channel_attention.cu``
and ``csrc/channel_attention_bwd.cu``, joined by one
``torch.autograd.Function``; ``plain_channel_attention`` mirrors
``xla_channel_attention`` (:29) and ``plain_channel_attention_bwd`` the
backward kernel body (``_bwd_kernel``, :94). The forward runs bf16 on the
tensor cores at windows of up to 128 tokens and head dims that are
multiples of 8 up to 128, f32 and the other shapes on the CUDA cores (the
rule ``channel_mma`` in ``csrc/channel_attention.cu``); the backward runs
on the CUDA cores.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import SMEM_LIMIT, check, dtype_code, is_plain, launch, library, ptr


def plain_channel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Per window and head, softmax over e of S[d, e] = sum_n q[n, d] k[n, e]
    * scale, then out[n, d] = sum_e P[d, e] v[n, e]. q: (BW, N, C); k, v:
    (BW, N, EC); C / heads and EC / heads may differ. The scores are taken in
    q's dtype and scaled in f32; P is cast back to q's dtype, as in the JAX
    version."""
    bw, n, c = q.shape
    ec = k.shape[-1]
    nh = num_heads
    qh = q.reshape(bw, n, nh, c // nh)
    kh = k.reshape(bw, n, nh, ec // nh)
    vh = v.reshape(bw, n, nh, ec // nh)
    attn = torch.einsum("bnhd,bnhe->bhde", qh, kh)
    attn = (attn.float() * scale).softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhde,bnhe->bnhd", attn, vh).reshape(bw, n, c)


def plain_channel_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                dout: torch.Tensor, num_heads: int, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`plain_channel_attention`, step by step as the
    JAX backward kernel computes them: S, P and dP in f32, dS = P * (dP -
    rowsum(dP * P)) * scale, P and dS cast to the input dtype before the dq,
    dk and dv products."""
    bw, n, c = q.shape
    ec = k.shape[-1]
    nh = num_heads
    qh = q.reshape(bw, n, nh, c // nh).float()
    doh = dout.reshape(bw, n, nh, c // nh).float()
    kh = k.reshape(bw, n, nh, ec // nh).float()
    vh = v.reshape(bw, n, nh, ec // nh).float()
    p = (torch.einsum("bnhd,bnhe->bhde", qh, kh) * scale).softmax(dim=-1)
    dp = torch.einsum("bnhd,bnhe->bhde", doh, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    p_lo = p.to(dout.dtype).float()
    ds_lo = ds.to(q.dtype).float()
    dv = torch.einsum("bnhd,bhde->bnhe", doh, p_lo)
    dq = torch.einsum("bnhe,bhde->bnhd", kh, ds_lo)
    dk = torch.einsum("bnhd,bhde->bnhe", qh, ds_lo)
    return (dq.to(q.dtype).reshape(bw, n, c), dk.to(k.dtype).reshape(bw, n, ec),
            dv.to(v.dtype).reshape(bw, n, ec))


def pair_smem_bytes(n: int, hd: int, ehd: int) -> int:
    """Shared memory of one (window, head) pair of the backward kernel:
    ``channel_pair_bwd_smem_floats`` in ``csrc/common.cuh``."""
    return (2 * n * hd + 2 * n * ehd + 2 * hd * (ehd + 1)) * 4


def _check_inputs(q, kv, num_heads, backward: bool = False) -> Tuple[int, int, int, int]:
    """Raise on what the kernels do not take: bf16 tensors of the forward
    that do not start on 16 bytes (its tensor-core body copies 16-byte
    pieces) and blocks beyond a block's shared memory (the forward's as its
    source counts it). Return (bw, n, c, ec)."""
    bw, n, c = q.shape
    ec2 = kv.shape[-1]
    if ec2 % 2 or c % num_heads or (ec2 // 2) % num_heads:
        raise ValueError(f"channel_attention: q's {c} and kv's {ec2} fused channels do not "
                         f"split into {num_heads} heads (kv holds k | v)")
    ec = ec2 // 2
    check("q", q, (bw, n, c), q.dtype, q.device)
    check("kv", kv, (bw, n, 2 * ec), q.dtype, q.device)
    code = dtype_code(q)
    if backward:
        need = pair_smem_bytes(n, c // num_heads, ec // num_heads)
    else:
        if q.dtype == torch.bfloat16:
            for name, t in (("q", q), ("kv", kv)):
                if t.data_ptr() % 16:
                    raise ValueError(f"channel_attention: {name} does not start on a 16-byte "
                                     f"boundary")
        need = library().mde_channel_attention_smem(n, c, ec, num_heads, code)
    if need > SMEM_LIMIT:
        raise ValueError(f"channel_attention{'_bwd' if backward else ''}: N={n}, head dims "
                         f"{c // num_heads} x {ec // num_heads} need {need} bytes of shared "
                         f"memory {'per (window, head)' if backward else 'a block'}; a "
                         f"block has {SMEM_LIMIT}")
    return bw, n, c, ec


def channel_attention_bwd(q: torch.Tensor, kv: torch.Tensor, dout: torch.Tensor,
                          num_heads: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, dkv in kv's fused k | v layout) for the output gradient dout:
    the plain version for CPU tensors, the backward kernel for CUDA
    tensors."""
    ec = kv.shape[-1] // 2
    if is_plain(q):
        dq, dk, dv = plain_channel_attention_bwd(q, kv[..., :ec], kv[..., ec:], dout,
                                                 num_heads, scale)
        return dq, torch.cat([dk, dv], dim=-1)
    bw, n, c, ec = _check_inputs(q, kv, num_heads, backward=True)
    check("dout", dout, (bw, n, c), q.dtype, q.device)
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    launch("channel_attention_bwd", "mde_channel_attention_bwd", q.device, ptr(q), ptr(kv),
           ptr(dout), ptr(dq), ptr(dkv), bw, n, c, ec, num_heads, float(scale), dtype_code(q))
    return dq, dkv


class ChannelAttentionFn(torch.autograd.Function):
    """K5 forward and backward over q and the fused (BW, N, 2 EC) kv
    projection; kv's gradient comes back in the same fused layout."""

    @staticmethod
    def forward(ctx, q, kv, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(q, kv)
        ec = kv.shape[-1] // 2
        if is_plain(q):
            return plain_channel_attention(q, kv[..., :ec], kv[..., ec:], num_heads, scale)
        bw, n, c, ec = _check_inputs(q, kv, num_heads)
        out = torch.empty_like(q)
        launch("channel_attention", "mde_channel_attention", q.device, ptr(q), ptr(kv),
               ptr(out), bw, n, c, ec, num_heads, float(scale), dtype_code(q))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv = ctx.saved_tensors
        dq, dkv = channel_attention_bwd(q, kv, dout.contiguous(), ctx.num_heads, ctx.scale)
        return dq, dkv, None, None


def channel_attention(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                      scale: float) -> torch.Tensor:
    """Channel cross attention of decoder windows q (BW, N, C) over encoder
    windows whose k and v projections are fused as kv (BW, N, 2 EC) = k | v
    -> (BW, N, C), differentiable in q and kv: the plain versions for CPU
    tensors, the CUDA kernels for CUDA tensors."""
    return ChannelAttentionFn.apply(q, kv, num_heads, scale)
