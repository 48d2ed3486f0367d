"""Ordered depth-bias shifted-window attention
(``mde_tpu/ops/ordered_attention.py``), through kernel K2."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .drop import Dropout
from .init import depth_embedding_init
from .kernels.ordered_attention import ordered_attention
from .remat import tag_sa
from .tnn import LayerNorm, Linear
from .window import cyclic_shift, cyclic_unshift, window_partition, window_reverse


class PreNormOrderedSwinSA(nn.Module):
    """Pre-norm residual ordered window self-attention.

    ``x``: (B, H, W, C); ``indices``: (B, H, W) integer depth indices in
    [0, num_emb). The logits of each window get ``depth_embedding[i_q - i_k
    + num_emb - 1, head]``. The shifted variant rolls both x and the indices
    and applies no shift mask, as the reference does. ``bias_type="none"``
    (the gen-1 head) holds no table and takes no indices.

    ``drop_prob`` drops ``o_proj``'s output (``mde_tpu/ops/ordered_attention.py:146``).
    With ``attn_drop_prob`` > 0 in training the attention runs JAX's einsum
    path instead of the kernel, as JAX's module does (``:126-143``); there
    the reference drops the scaled **logits**, before the depth bias and
    the f32 softmax, where the other attentions drop probabilities."""

    def __init__(self, dim: int, num_heads: int, num_emb: int, window_size: int = 8,
                 shift_size: int = 0, bias_type: str = "depth", bias_init: str = "linear",
                 attn_drop_prob: float = 0.0, drop_prob: float = 0.0):
        super().__init__()
        if bias_type not in ("depth", "none"):
            raise NotImplementedError(f"bias_type {bias_type!r}")
        self.attn_drop = Dropout(attn_drop_prob)
        self.drop = Dropout(drop_prob)
        self.num_heads = num_heads
        self.num_emb = num_emb
        self.window_size = window_size
        self.shift_size = shift_size
        self.bias_init = bias_init
        self.norm = LayerNorm(dim)
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.o_proj = Linear(dim, dim)
        self.depth_embedding = (nn.Parameter(torch.zeros(2 * num_emb - 1, num_heads))
                                if bias_type == "depth" else None)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        if self.depth_embedding is not None:
            self.depth_embedding.data.copy_(depth_embedding_init(
                self.num_emb, self.num_heads, self.bias_init, generator))

    def forward(self, x: torch.Tensor, indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        r, s = self.window_size, self.shift_size
        identity = x
        x = cyclic_shift(x, s)
        xn = self.norm(window_partition(x, r))
        q, k, v = self.q_proj(xn), self.k_proj(xn), self.v_proj(xn)
        idx = None
        if self.depth_embedding is not None:
            indices = cyclic_shift(indices[..., None], s)
            idx = window_partition(indices.to(torch.int32), r)[..., 0].contiguous()
        scale = (c // self.num_heads) ** -0.5
        if self.training and self.attn_drop.rate > 0:
            out = self._dropout_attention(q, k, v, idx, scale, generator)
        else:
            out = ordered_attention(q, k, v, idx, self.depth_embedding, self.num_heads, scale,
                                    self.num_emb)
        out = window_reverse(self.drop(self.o_proj(out), generator), r, h, w)
        # kept by a recomputing block under the save_sa policies (ops/remat.py)
        return tag_sa(cyclic_unshift(out, s) + identity)

    def _dropout_attention(self, q, k, v, idx, scale, generator) -> torch.Tensor:
        """JAX's einsum path over (BW, n, C) windows: the logits q . k times
        the scale in the activation dtype, dropped, plus the gathered depth
        bias ``table[i_q - i_k + E - 1]`` (none without a table), softmax in
        f32, cast back, then P . v."""
        bw, n, c = q.shape
        nh = self.num_heads
        q, k, v = (t.reshape(bw, n, nh, c // nh) for t in (q, k, v))
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * torch.tensor(scale, dtype=q.dtype)
        attn = self.attn_drop(attn, generator)
        if self.depth_embedding is not None:
            rel = (idx[:, :, None] - idx[:, None, :] + (self.num_emb - 1)).long()
            attn = attn + self.depth_embedding[rel].permute(0, 3, 1, 2).to(attn.dtype)
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bw, n, c)
