"""Layers with the JAX package's numerics (``mde_tpu/ops/tnn.py``).

Parameters are kept in f32; each layer computes in the dtype of its input,
so a model runs in bf16 by casting its input once, as the JAX modules'
``dtype`` field does. LayerNorm's eps is 1e-5 (torch's), GELU follows the
JAX dtype rule (exact erf in f32, the tanh form in bf16), and BatchNorm and
GroupNorm compute (and BatchNorm keeps) their statistics as flax does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import dist


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, or its tanh form for bf16 input (``tnn.gelu``)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Linear(nn.Linear):
    """``nn.Linear`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, eps 1e-5, in the input's dtype. Its
    scale starts at ``scale_init`` (flax's ``scale_init`` constant)."""

    def __init__(self, dim: int, eps: float = 1e-5, scale_init: float = 1.0):
        self.scale_init = scale_init
        super().__init__(dim, eps=eps)

    def reset_parameters(self) -> None:
        super().reset_parameters()
        nn.init.constant_(self.weight, self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the last (channel) dim of NHWC input with flax's
    numerics (flax 0.12 ``BatchNorm``, ``_compute_stats``), not torch's.

    In training the statistics are taken in f32 whatever the input dtype,
    the variance as ``E[x^2] - E[x]^2`` clipped at 0, and the running
    averages are updated in place as ``m * running + (1 - m) * batch`` with
    flax's ``m = 1 - momentum`` and the *biased* variance
    (``mde_tpu/ops/conv.py:63-65``); ``F.batch_norm`` would store the
    unbiased one. The input is normalised in f32 in flax's order,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and cast back.

    Running statistics normalise, and stay as they are, in eval mode or
    while ``frozen`` (:func:`bn_freeze_scope`). While ``replaying`` (the
    recompute of a checkpointed block, ``ops/remat.py``) batch statistics
    normalise but the running ones are not updated a second time.
    ``num_batches_tracked`` is kept for the state dict and never read.

    Inside a global-batch scope (``parallel.mesh.gspmd_scope``) the batch
    statistics are those of the global batch, as under JAX's GSPMD step
    (SyncBN): the f32 per-channel sums of x and x^2 and the row count are
    summed over the ranks in one collective (``core.dist.sum_over_ranks``,
    whose backward carries the gradient through every rank's rows), and
    the running averages, updated from them, come out the same on every
    rank. A replay sums the same values again. Under a (data, model) mesh
    the sums go over the data group, whose ranks hold the other rows.

    ``channels`` (a slice) normalises x as those channels of the layer:
    a tensor-parallel feed-forward's slice of its hidden channels
    (``ops/mlp.py``); only their running statistics are updated."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.frozen = False
        self.replaying = False

    def forward(self, x: torch.Tensor, channels: slice = slice(None)) -> torch.Tensor:
        running_mean, running_var = self.running_mean[channels], self.running_var[channels]
        if bn_use_running_average(self):
            mean, var = running_mean, running_var
        else:
            x32 = x.float()
            dims = tuple(range(x.dim() - 1))
            scope = dist.global_batch()
            if scope is None:
                mean = x32.mean(dim=dims)
                var = ((x32 * x32).mean(dim=dims) - mean * mean).clamp_min(0.0)
            else:
                rows = torch.full((1,), float(x32.numel() // x32.shape[-1]), device=x.device)
                s1, s2, n = dist.sum_over_ranks([x32.sum(dim=dims), (x32 * x32).sum(dim=dims),
                                                 rows], scope.data_group)
                mean = s1 / n
                var = (s2 / n - mean * mean).clamp_min(0.0)
            if not self.replaying:
                m = 1.0 - self.momentum
                with torch.no_grad():
                    running_mean.copy_(m * running_mean + (1.0 - m) * mean)
                    running_var.copy_(m * running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight[channels]
        return ((x.float() - mean) * mul + self.bias[channels]).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the last (channel) dim of NHWC input with flax's
    numerics (flax 0.12 ``GroupNorm``): each group's statistics over its
    pixels and channels in f32, the variance as ``E[x^2] - E[x]^2``
    clipped at 0, eps 1e-5, the input normalised in f32 as
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and cast back to its
    dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.num_groups
        x32 = x.float().reshape(*x.shape[:-1], g, x.shape[-1] // g)
        dims = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        mean = x32.mean(dim=dims, keepdim=True)
        var = ((x32 * x32).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, -1)
        y = (x32 - mean) * mul + self.bias.reshape(g, -1)
        return y.reshape(x.shape).to(x.dtype)


def bn_use_running_average(bn: BatchNorm) -> bool:
    """A BatchNorm normalises with its running statistics in eval mode or
    inside a freeze scope that covers it (``mde_tpu/ops/tnn.py:86-94``)."""
    return not bn.training or bn.frozen


def encoder_only(path: Tuple[str, ...]) -> bool:
    """Freeze predicate for ``freeze_encoder_bn``: the model's ``encoder``
    subtree."""
    return len(path) > 0 and path[0] == "encoder"


@contextlib.contextmanager
def bn_freeze_scope(model: nn.Module,
                    predicate: Optional[Callable[[Tuple[str, ...]], bool]] = None):
    """While active, the BatchNorms of ``model`` whose module path (the
    qualified name split at its dots) satisfies ``predicate`` (default: all)
    normalise with running statistics and leave them unchanged even in
    training mode: the reference's ``freeze_bn``, ``m.eval()``
    (``mde_tpu/ops/tnn.py:50-77``). The flags live on the modules, so the
    backward pass (and any recompute in it) must run inside the scope too."""
    predicate = predicate or (lambda path: True)
    frozen = [m for name, m in model.named_modules()
              if isinstance(m, BatchNorm) and predicate(tuple(name.split(".")))]
    for m in frozen:
        m.frozen = True
    try:
        yield
    finally:
        for m in frozen:
            m.frozen = False


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """Convolution of NHWC ``x`` with an OIHW weight, in x's dtype: VALID,
    or after ``padding`` zeros on every side; ``groups`` as ``F.conv2d``'s."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)
