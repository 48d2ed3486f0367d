"""K2: ordered depth-bias window attention, forward and backward.

Port of ``fused_ordered_window_attention``
(``mde_tpu/ops/pallas/ordered_attention.py:513``) and its ``custom_vjp``.
The CUDA kernels are ``csrc/ordered_attention.cu`` and
``csrc/ordered_attention_bwd.cu``, joined by one ``torch.autograd.Function``;
``plain_ordered_attention`` mirrors ``xla_ordered_attention`` (:83) and
``plain_ordered_attention_bwd`` the backward kernel body (``_bwd_kernel``,
:299) with its table fold (:461-466). The forward is the operator
``torch.ops.mde.ordered_attention`` (``torch.library.custom_op``); the
backward is called through ``ctypes``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import check, check_smem, dtype_code, is_plain, launch, library, ptr


def _relative_index(idx: torch.Tensor, num_emb: int) -> torch.Tensor:
    """(B*nW, N, N) rows of the table: idx_q - idx_k + E - 1."""
    return idx[:, :, None].long() - idx[:, None, :].long() + (num_emb - 1)


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
        rel = _relative_index(idx, num_emb)
        attn = attn + table.t()[:, rel].permute(1, 0, 2, 3).float()
    attn = attn.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(bw, n, c)


def plain_ordered_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                dout: torch.Tensor, idx: torch.Tensor,
                                table: Optional[torch.Tensor], num_heads: int, scale: float,
                                num_emb: int
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                           Optional[torch.Tensor]]:
    """(dq, dk, dv, dtable) of :func:`plain_ordered_attention`, step by step
    as the JAX backward kernel computes them: q scaled in its dtype (the
    backward kernel does so, though the forward's plain path scales the f32
    logits), products in f32, P and dS cast to the input dtype before the
    dq, dk and dv products, dq scaled in f32, and
    dtable[a - b + E - 1, h] = sum of dS over pairs with (idx_q, idx_k) = (a, b),
    f32. dtable is None without a table."""
    bw, n, c = q.shape
    hd = c // num_heads
    dt = q.dtype
    qs = q * torch.tensor(scale, dtype=dt)
    qh, kh, vh, doh = (t.reshape(bw, n, num_heads, hd).float() for t in (qs, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if table is not None:
        rel = _relative_index(idx, num_emb)
        s = s + table.t()[:, rel].permute(1, 0, 2, 3).float()
    p = s.softmax(dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    p_lo = p.to(dout.dtype).float()
    ds_lo = ds.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_lo, doh)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, kh) * torch.tensor(scale, dtype=torch.float32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, qh)
    dtable = None
    if table is not None:
        per_head = ds.permute(1, 0, 2, 3).reshape(num_heads, -1)
        dtable = torch.zeros((num_heads, 2 * num_emb - 1), dtype=torch.float32,
                             device=q.device).index_add_(1, rel.reshape(-1), per_head).t()
    return (dq.to(dt).reshape(bw, n, c), dk.to(dt).reshape(bw, n, c),
            dv.to(dt).reshape(bw, n, c), dtable)


# the largest window and head dim the kernels take (csrc/attention_mma.cuh)
MAX_N = 128
MAX_HD = 128


def _check_inputs(q, k, v, idx, table, num_heads, num_emb, dout=None) -> None:
    """Raise on what the forward (or, given ``dout``, the backward) kernel
    does not take: windows of more than 128 tokens, head dims that are not a
    multiple of 8 up to 128, bf16 tensors that do not start on 16 bytes (the
    tensor-core kernels copy 16-byte pieces), and blocks beyond a block's
    shared memory (as the kernel's source counts it)."""
    bw, n, c = q.shape
    tensors = (("q", q), ("k", k), ("v", v)) + (() if dout is None else (("dout", dout),))
    for tname, t in tensors:
        check(tname, t, (bw, n, c), q.dtype, q.device)
    code = dtype_code(q)
    name = "ordered_attention" if dout is None else "ordered_attention_bwd"
    if c % num_heads:
        raise ValueError(f"{name}: {c} channels do not split into {num_heads} heads")
    hd = c // num_heads
    if n > MAX_N:
        raise ValueError(f"{name}: windows of {n} tokens; the kernels take at most {MAX_N}")
    if hd % 8 or hd > MAX_HD:
        raise ValueError(f"{name}: head dim {hd}; the kernels take multiples of 8 up to "
                         f"{MAX_HD}")
    if q.dtype == torch.bfloat16:
        for tname, t in tensors:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {tname} does not start on a 16-byte boundary")
    if table is not None:
        check("idx", idx, (bw, n), torch.int32, q.device)
        check("table", table, (2 * num_emb - 1, num_heads), torch.float32, q.device)
    smem = getattr(library(), f"mde_{name}_smem")
    check_smem(name, n, hd, smem(n, c, num_heads, num_emb, int(table is not None), code))


def ordered_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dout: torch.Tensor, idx: Optional[torch.Tensor],
                          table: Optional[torch.Tensor], num_heads: int, scale: float,
                          num_emb: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """(dq, dk, dv, dtable f32 or None without a table) for the output
    gradient dout: the plain version for CPU tensors, the backward kernel
    for CUDA tensors."""
    if is_plain(q):
        return plain_ordered_attention_bwd(q, k, v, dout, idx, table, num_heads, scale,
                                           num_emb)
    _check_inputs(q, k, v, idx, table, num_heads, num_emb, dout)
    bw, n, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dtable = None if table is None else torch.zeros_like(table)
    launch("ordered_attention_bwd", "mde_ordered_attention_bwd", q.device,
           ptr(q), ptr(k), ptr(v), ptr(dout), None if table is None else ptr(idx),
           ptr(table), ptr(dq), ptr(dk), ptr(dv), ptr(dtable), bw, n, c, num_heads,
           num_emb, float(scale), dtype_code(q))
    return dq, dk, dv, dtable


def direct_ordered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             idx: Optional[torch.Tensor], table: Optional[torch.Tensor],
                             num_heads: int, scale: float, num_emb: int) -> torch.Tensor:
    """The forward kernel on CUDA tensors, checked and launched without the
    operator's dispatch."""
    _check_inputs(q, k, v, idx, table, num_heads, num_emb)
    bw, n, c = q.shape
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    launch("ordered_attention", "mde_ordered_attention", q.device,
           ptr(q), ptr(k), ptr(v), None if table is None else ptr(idx), ptr(table),
           ptr(out), bw, n, c, num_heads, num_emb, float(scale), dtype_code(q))
    return out


@torch.library.custom_op("mde::ordered_attention", mutates_args=())
def ordered_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         idx: Optional[torch.Tensor], table: Optional[torch.Tensor],
                         num_heads: int, scale: float, num_emb: int) -> torch.Tensor:
    """K2's forward as an operator of its own (``torch.ops.mde.ordered_attention``),
    so that ``torch.export`` records it as one node: the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if is_plain(q):
        return plain_ordered_attention(q, k, v, idx, table, num_heads, scale, num_emb)
    return direct_ordered_attention(q, k, v, idx, table, num_heads, scale, num_emb)


@ordered_attention_op.register_fake
def _(q, k, v, idx, table, num_heads, scale, num_emb):
    is_plain(q)  # tracing takes CPU and CUDA tensors; the rest raise
    return torch.empty_like(q)


class OrderedAttentionFn(torch.autograd.Function):
    """K2 forward (``torch.ops.mde.ordered_attention``) and backward:
    gradients for q, k, v and the table; the indices get none."""

    @staticmethod
    def forward(ctx, q, k, v, idx, table, num_heads, scale, num_emb):
        ctx.num_heads, ctx.scale, ctx.num_emb = num_heads, scale, num_emb
        ctx.save_for_backward(q, k, v, idx, table)
        return ordered_attention_op(q, k, v, idx, table, num_heads, float(scale), num_emb)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, idx, table = ctx.saved_tensors
        # autograd may hand over a view (a slice of a larger gradient): the
        # kernel takes a contiguous one that starts on 16 bytes
        if not dout.is_contiguous() or dout.data_ptr() % 16:
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv, dtable = ordered_attention_bwd(q, k, v, dout, idx, table, ctx.num_heads,
                                                   ctx.scale, ctx.num_emb)
        return dq, dk, dv, None, dtable if ctx.needs_input_grad[4] else None, None, None, None


def ordered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      idx: Optional[torch.Tensor], table: Optional[torch.Tensor],
                      num_heads: int, scale: float, num_emb: int) -> torch.Tensor:
    """Ordered window MHA, differentiable in q, k, v and the table: the plain
    versions for CPU tensors, the CUDA kernels for CUDA tensors (which clamp
    indices into [0, num_emb), take windows of up to 128 tokens and head dims
    that are multiples of 8 up to 128, and run bf16 on the tensor cores)."""
    return OrderedAttentionFn.apply(q, k, v, idx, table, num_heads, scale, num_emb)
