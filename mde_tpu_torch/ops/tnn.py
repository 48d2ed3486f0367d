"""Layers with the JAX package's numerics (``mde_tpu/ops/tnn.py``).

Parameters are kept in f32; each layer computes in the dtype of its input,
so a model runs in bf16 by casting its input once, as the JAX modules'
``dtype`` field does. LayerNorm's eps is 1e-5 (torch's), GELU follows the
JAX dtype rule (exact erf in f32, the tanh form in bf16), and BatchNorm
computes and keeps its statistics as flax does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, or its tanh form for bf16 input (``tnn.gelu``)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Linear(nn.Linear):
    """``nn.Linear`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, eps 1e-5, in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

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
    ``num_batches_tracked`` is kept for the state dict and never read."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.frozen = False
        self.replaying = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if bn_use_running_average(self):
            mean, var = self.running_mean, self.running_var
        else:
            x32 = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=dims)
            var = ((x32 * x32).mean(dim=dims) - mean * mean).clamp_min(0.0)
            if not self.replaying:
                m = 1.0 - self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)


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
                stride: int = 1) -> torch.Tensor:
    """VALID convolution of NHWC ``x`` with an OIHW weight, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)
