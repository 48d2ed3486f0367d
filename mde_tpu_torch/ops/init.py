"""Random initialisation with the JAX package's distributions
(``mde_tpu/ops/init.py``, flax's defaults, ``depth_embedding_init``), drawn
from a ``torch.Generator`` so that a seed fixes the weights."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std^2) truncated to [-2 std, 2 std], by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    t.uniform_(2 * lo - 1, 1 - 2 * lo, generator=generator)
    return t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv kernel init: truncated normal, variance 1/fan_in."""
    fan_in = t[0].numel()
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)


def xavier_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``xavier_normal`` of a (fan_in, fan_out) table: truncated
    normal, variance 2 / (fan_in + fan_out)."""
    std = math.sqrt(2.0 / (t.shape[0] + t.shape[1])) / 0.87962566103423978
    return trunc_normal_(t, std, generator)


def conv_kernel_normal_(t: torch.Tensor, kernel_h: int, kernel_w: int,
                        generator: torch.Generator) -> torch.Tensor:
    """N(0, 2/(kh*kw)): the depthwise-conv FF init."""
    return t.normal_(0.0, math.sqrt(2.0 / (kernel_h * kernel_w)), generator=generator)


def depth_embedding_init(num_emb: int, num_heads: int, mode: str,
                         generator: torch.Generator) -> torch.Tensor:
    """The (2*num_emb-1, num_heads) relative-depth bias table. ``linear``
    gives row r (centred) the value -|r| * u_h, u_h ~ U(0.01, 0.04) per
    head: the further apart two depth indices, the less they attend."""
    if mode == "linear":
        u = torch.empty(num_heads).uniform_(0.01, 0.04, generator=generator)
        rel = torch.arange(1, 2 * num_emb, dtype=torch.float32) - num_emb
        sign = torch.where(torch.arange(2 * num_emb - 1) < num_emb - 1, 1.0, -1.0)
        return rel[:, None] * sign[:, None] * u[None, :]
    if mode == "random":
        return torch.empty(2 * num_emb - 1, num_heads).uniform_(-0.05, 0.05,
                                                                generator=generator)
    raise ValueError(f"Unsupported bias init {mode}.")


def depth_bins_init(num_emb: int) -> torch.Tensor:
    """The cls head's (num_emb,) learnable depth bins as JAX starts them
    (``mde_tpu/models/oda2/red_order_reg.py:211-218``): 0.001, then
    exp(linspace(-10, 0, num_emb - 1)) without its last value, then 0.999."""
    bins = np.exp(np.linspace(-10.0, 0.0, num_emb - 1)[:-1]).tolist()
    return torch.tensor([0.001] + bins + [0.999], dtype=torch.float32)


@contextlib.contextmanager
def no_default_init():
    """While active, ``nn.Linear`` and ``nn.Conv2d`` skip torch's own
    parameter init when built: :func:`init_weights` draws every one of
    them again, and torch's init took half of a Swin-L model's build."""
    real = nn.Linear.reset_parameters, nn.Conv2d.reset_parameters
    nn.Linear.reset_parameters = nn.Conv2d.reset_parameters = lambda self: None
    try:
        yield
    finally:
        nn.Linear.reset_parameters, nn.Conv2d.reset_parameters = real


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` as the JAX modules initialise it:
    dense kernels truncated normal 0.02 with zero bias, conv kernels lecun
    normal, norms one and zero (BN statistics 0 and 1), and each module's
    own tensors through its ``init_own_parameters(generator)``."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
        own = getattr(m, "init_own_parameters", None)
        if own is not None:
            own(generator)
    return model
