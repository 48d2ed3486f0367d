"""K1: window multi-head attention (W-MSA / SW-MSA), forward and backward.

Port of ``fused_window_attention`` (``mde_tpu/ops/pallas/window_attention.py:352``)
and its ``custom_vjp``. The CUDA kernels are ``csrc/window_attention.cu`` and
``csrc/window_attention_bwd.cu``; each takes q, k and v as strided views, q
and k at one row stride and v at its own, and writes each gradient laid
out like its input. Two ``torch.autograd.Function``s bind them: one over the
Swin blocks' fused (B*nW, N, 3C) qkv projection (:func:`window_attention`),
one over the NewCRFs blocks' fused (B*nW, N, 2C) qk projection and separate
(B*nW, N, C) v (:func:`window_attention_qk_v`); neither copies a slice or
concatenates. ``plain_window_attention`` mirrors ``xla_window_attention`` (:77) and
``plain_window_attention_bwd`` the backward kernel body (``_bwd_kernel``,
:180). Each forward entry is an operator of its own in the ``mde``
namespace (``torch.library.custom_op``, with a fake that gives only the
output's shape and dtype), which ``torch.export`` records as one node; the
backward entries are called through ``ctypes`` from the
``autograd.Function``s. bf16 windows of up to 128 tokens at head dims that are multiples of
8 up to 128, and of up to 144 tokens (the ODA encoder's 12 x 12 windows) at
head dims that are multiples of 8 up to 32, run on the tensor cores; f32,
and bf16 beyond those shapes, on the CUDA cores (the rule
``window_mma_shape`` in ``csrc/attention_mma.cuh``). A shape whose block
would not fit the card's shared memory is refused before any launch.
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


def _check_inputs(name: str, views, c: int, bias, mask, num_heads: int, dout=None,
                  strides=False) -> int:
    """Raise on what the forward (or, given ``dout``, the backward) kernel
    does not take. ``views``: (name, tensor, expected shape) of each input
    holding q, k and v. Each must be contiguous, of one dtype and device;
    in bf16 each must start on 16 bytes (the tensor-core kernels copy
    16-byte pieces), and with ``strides`` its rows too (a row stride that
    is a multiple of 8). Blocks beyond a block's shared memory (as the
    kernel's source counts it) are refused. Return the mask's nW (0 for no
    mask)."""
    first = views[0][1]
    bw, n = first.shape[:2]
    if c % num_heads:
        raise ValueError(f"{name}: {c} channels do not split into {num_heads} heads")
    if dout is not None:
        views = tuple(views) + (("dout", dout, (bw, n, c)),)
    for tname, t, shape in views:
        check(tname, t, shape, first.dtype, first.device)
    code = dtype_code(first)
    if first.dtype == torch.bfloat16:
        for tname, t, shape in views:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {tname} does not start on a 16-byte boundary")
            if strides and shape[-1] % 8:
                raise ValueError(f"{name}: {tname}'s rows of {shape[-1]} bf16 elements do not "
                                 f"start on 16-byte boundaries")
    if dout is None:
        need = library().mde_window_attention_smem(n, c, num_heads, code)
    else:
        need = library().mde_window_attention_bwd_smem(n, c, num_heads, int(bias is not None),
                                                       code)
    check_smem(name, n, c // num_heads, need)
    if bias is not None:
        check("bias", bias, (num_heads, n, n), torch.float32, first.device)
    if mask is None:
        return 0
    nw = mask.shape[0]
    check("mask", mask, (nw, n, n), torch.float32, first.device)
    if bw % nw:
        raise ValueError(f"{name}: {bw} windows are not a multiple of the mask's {nw}")
    return nw


def _fused_views(qkv: torch.Tensor, c: int):
    """The views a fused qkv projection of q, k and v of c channels must be."""
    return (("qkv", qkv, (*qkv.shape[:2], 3 * c)),)


def _qk_v_views(qk: torch.Tensor, v: torch.Tensor):
    """The views a fused qk projection and its v must be."""
    return ("qk", qk, (*v.shape[:2], 2 * v.shape[-1])), ("v", v, tuple(v.shape))


def _forward(q, k, v, ld, ldv, bias, mask, num_heads, scale, nw, entry=None):
    """Launch the forward kernel on the views q, k (rows ld apart) and v
    (rows ldv apart) of (bw, n, c) -> out (bw, n, c); ``entry`` names the
    q|k + v entry in ``kernels.entry_counts``."""
    bw, n, c = q.shape
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    launch("window_attention", "mde_window_attention", q.device,
           ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(out),
           bw, n, c, num_heads, ld, ldv, nw, float(scale), dtype_code(q), counted_entry=entry)
    return out


def _backward(q, k, v, ld, ldv, dout, bias, mask, num_heads, scale, nw, dq, dk, dv,
              entry=None):
    """Launch the backward kernel: dq, dk, dv laid out like q, k, v; return
    dbias (f32, None without a bias)."""
    bw, n, c = dout.shape
    dbias = (None if bias is None else
             torch.zeros((num_heads, n, n), dtype=torch.float32, device=dout.device))
    launch("window_attention_bwd", "mde_window_attention_bwd", dout.device,
           ptr(q), ptr(k), ptr(v), ptr(dout), ptr(bias), ptr(mask), ptr(dq), ptr(dk), ptr(dv),
           ptr(dbias), bw, n, c, num_heads, ld, ldv, nw, float(scale), dtype_code(dout),
           counted_entry=entry)
    return dbias


def window_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                         bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                         num_heads: int, scale: float
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dqkv in qkv's fused layout, dbias f32 or None without a bias) for
    the output gradient dout: the plain version for CPU tensors, the
    backward kernel for CUDA tensors."""
    c = qkv.shape[-1] // 3
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    if is_plain(qkv):
        dq, dk, dv, dbias = plain_window_attention_bwd(q, k, v, dout, bias, mask, num_heads,
                                                       scale)
        return torch.cat([dq, dk, dv], dim=-1), dbias
    nw = _check_inputs("window_attention_bwd", _fused_views(qkv, c), c, bias, mask, num_heads,
                       dout)
    dqkv = torch.empty_like(qkv)
    dbias = _backward(q, k, v, 3 * c, 3 * c, dout, bias, mask, num_heads, scale, nw,
                      dqkv[..., :c], dqkv[..., c:2 * c], dqkv[..., 2 * c:])
    return dqkv, dbias


def window_attention_qk_v_bwd(qk: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                              bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                              num_heads: int, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dqk in qk's fused layout, dv, dbias f32 or None without a bias) for
    the output gradient dout: the plain version for CPU tensors, the
    backward kernel for CUDA tensors."""
    c = v.shape[-1]
    q, k = qk[..., :c], qk[..., c:]
    if is_plain(qk):
        dq, dk, dv, dbias = plain_window_attention_bwd(q, k, v, dout, bias, mask, num_heads,
                                                       scale)
        return torch.cat([dq, dk], dim=-1), dv, dbias
    nw = _check_inputs("window_attention_qk_v_bwd", _qk_v_views(qk, v), c, bias, mask,
                       num_heads, dout, strides=True)
    dqk, dv = torch.empty_like(qk), torch.empty_like(v)
    dbias = _backward(q, k, v, 2 * c, c, dout, bias, mask, num_heads, scale, nw,
                      dqk[..., :c], dqk[..., c:], dv, entry="window_attention_qk_v_bwd")
    return dqk, dv, dbias


def _contiguous_grad(dout: torch.Tensor) -> torch.Tensor:
    """autograd may hand over a view (a slice of a larger gradient): the
    kernels take a contiguous one that starts on 16 bytes."""
    if not dout.is_contiguous() or dout.data_ptr() % 16:
        dout = dout.clone(memory_format=torch.contiguous_format)
    return dout


def direct_window_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                            mask: Optional[torch.Tensor], num_heads: int,
                            scale: float) -> torch.Tensor:
    """The forward kernel over the fused qkv projection of CUDA tensors,
    checked and launched without the operator's dispatch."""
    c = qkv.shape[-1] // 3
    nw = _check_inputs("window_attention", _fused_views(qkv, c), c, bias, mask, num_heads)
    return _forward(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], 3 * c, 3 * c, bias,
                    mask, num_heads, scale, nw)


def direct_window_attention_qk_v(qk: torch.Tensor, v: torch.Tensor,
                                 bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                                 num_heads: int, scale: float) -> torch.Tensor:
    """The forward kernel over a fused qk projection and a separate v of
    CUDA tensors, checked and launched without the operator's dispatch."""
    c = v.shape[-1]
    nw = _check_inputs("window_attention_qk_v", _qk_v_views(qk, v), c, bias, mask, num_heads,
                       strides=True)
    return _forward(qk[..., :c], qk[..., c:], v, 2 * c, c, bias, mask, num_heads, scale, nw,
                    entry="window_attention_qk_v")


@torch.library.custom_op("mde::window_attention", mutates_args=())
def window_attention_op(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                        mask: Optional[torch.Tensor], num_heads: int,
                        scale: float) -> torch.Tensor:
    """K1's forward over the fused qkv projection as an operator of its own
    (``torch.ops.mde.window_attention``), so that ``torch.export`` records
    it as one node: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if is_plain(qkv):
        c = qkv.shape[-1] // 3
        return plain_window_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                                      mask, num_heads, scale)
    return direct_window_attention(qkv, bias, mask, num_heads, scale)


@window_attention_op.register_fake
def _(qkv, bias, mask, num_heads, scale):
    is_plain(qkv)  # tracing takes CPU and CUDA tensors; the rest raise
    return qkv.new_empty((*qkv.shape[:2], qkv.shape[-1] // 3))


@torch.library.custom_op("mde::window_attention_qk_v", mutates_args=())
def window_attention_qk_v_op(qk: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
                             mask: Optional[torch.Tensor], num_heads: int,
                             scale: float) -> torch.Tensor:
    """K1's forward over the fused qk projection and a separate v
    (``torch.ops.mde.window_attention_qk_v``)."""
    if is_plain(qk):
        c = v.shape[-1]
        return plain_window_attention(qk[..., :c], qk[..., c:], v, bias, mask, num_heads, scale)
    return direct_window_attention_qk_v(qk, v, bias, mask, num_heads, scale)


@window_attention_qk_v_op.register_fake
def _(qk, v, bias, mask, num_heads, scale):
    is_plain(qk)  # tracing takes CPU and CUDA tensors; the rest raise
    return torch.empty_like(v)


class WindowAttentionFn(torch.autograd.Function):
    """K1 forward (``torch.ops.mde.window_attention``) and backward over the
    fused (B*nW, N, 3C) qkv projection; the gradient comes back in the same
    fused layout, so autograd adds no slice copies. The mask is a constant
    and gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, bias, mask)
        return window_attention_op(qkv, bias, mask, num_heads, float(scale))

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, _contiguous_grad(dout), bias, mask,
                                           ctx.num_heads, ctx.scale)
        return dqkv, dbias if ctx.needs_input_grad[1] else None, None, None, None


class WindowAttentionQkVFn(torch.autograd.Function):
    """K1 forward (``torch.ops.mde.window_attention_qk_v``) and backward
    over a fused (B*nW, N, 2C) qk projection and a separate (B*nW, N, C) v;
    the gradients come back as a fused dqk and a dv, so autograd adds no
    slice or concatenation copies. The mask is a constant and gets no
    gradient."""

    @staticmethod
    def forward(ctx, qk, v, bias, mask, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qk, v, bias, mask)
        return window_attention_qk_v_op(qk, v, bias, mask, num_heads, float(scale))

    @staticmethod
    def backward(ctx, dout):
        qk, v, bias, mask = ctx.saved_tensors
        dqk, dv, dbias = window_attention_qk_v_bwd(qk, v, _contiguous_grad(dout), bias, mask,
                                                   ctx.num_heads, ctx.scale)
        return dqk, dv, dbias if ctx.needs_input_grad[2] else None, None, None, None


def window_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], num_heads: int,
                     scale: float) -> torch.Tensor:
    """Window MHA over the fused projection ``qkv`` (B*nW, N, 3C) = q | k | v
    along the last dim -> (B*nW, N, C), differentiable in qkv and bias: the
    plain versions for CPU tensors, the CUDA kernels for CUDA tensors (a
    bf16 ``qkv`` must start on 16 bytes)."""
    return WindowAttentionFn.apply(qkv, bias, mask, num_heads, scale)


def window_attention_qk_v(qk: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
                          mask: Optional[torch.Tensor], num_heads: int,
                          scale: float) -> torch.Tensor:
    """Window MHA with q | k fused along the last dim of ``qk`` (B*nW, N, 2C)
    and ``v`` (B*nW, N, C) apart -> (B*nW, N, C), differentiable in qk, v
    and bias: the plain versions for CPU tensors, the CUDA kernels for CUDA
    tensors (bf16 tensors must start on 16 bytes, C a multiple of 8)."""
    return WindowAttentionQkVFn.apply(qk, v, bias, mask, num_heads, scale)
