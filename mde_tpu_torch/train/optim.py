"""The optimizer of the port (``mde_tpu/train/optim.py``): optax's
``clip_by_global_norm`` and ``adamw`` under a OneCycle schedule, written out
so that one step gives what the JAX step gives. ``torch.optim.AdamW`` and
``clip_grad_norm_`` are not used: the first applies weight decay before the
Adam update and the second divides by ``norm + 1e-6``.

Per step, on the gradients g of the parameters p that get an update:

- clip: with n the global norm of g, g = (g / n) * max_norm when n >= max_norm;
- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, t = count + 1,
  u = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps), with mu then stored
  in ``moment_dtype`` (the update is computed from the f32 mu first);
- decay: u = u + weight_decay * p, on every parameter (optax's ``adamw``
  without a mask);
- u = -lr(count) * u, times 0.1 for the encoder when ``same_lr`` is False
  (the whole update, decay included);
- p = p + u.

``zero_grad_bn`` gives the BatchNorm parameters no update and no moments,
and leaves them out of the clip's norm, as optax's ``multi_transform`` with
``set_to_zero`` does. ``cycle_momentum`` makes b1 follow its own schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops.tnn import BatchNorm

Schedule = Callable[[int], float]

_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _cosine_interpolate(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def onecycle_schedule(total_steps: int, peak_value: float, pct_start: float = 0.3,
                      div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """``optax.cosine_onecycle_schedule``: from ``peak / div_factor`` up to
    ``peak`` over the first ``int(pct_start * total)`` steps, then down to
    ``peak / (div_factor * final_div_factor)`` at ``total``, each leg a
    cosine interpolation; constant after."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [peak_value / div_factor]
    for scale in (div_factor, 1.0 / (div_factor * final_div_factor)):
        values.append(values[-1] * scale)

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return _cosine_interpolate(values[i], values[i + 1], pct)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


def build_lr_schedule(opt, total_steps: int) -> Schedule:
    """The config's ``scheduler`` (``onecycle`` or ``constant``) at the
    config's ``optimizer.lr``."""
    sched = opt.get("scheduler", {})
    name = sched.get("name", "onecycle")
    peak_lr = float(opt["optimizer"]["lr"])
    if name == "onecycle":
        return onecycle_schedule(max(total_steps, 1), peak_lr,
                                 float(sched.get("pct_start", 0.25)),
                                 float(sched.get("div_factor", 25)),
                                 float(sched.get("final_div_factor", 100)))
    if name in ("constant", "none"):
        return lambda count: peak_lr
    raise ValueError(f"Unsupported scheduler {name}.")


def build_momentum_schedule(opt, total_steps: int) -> Optional[Schedule]:
    """torch's ``OneCycleLR(cycle_momentum=True)``: b1 falls from
    ``max_momentum`` to ``base_momentum`` over the warm-up and rises back
    over the anneal, cosine-shaped, inverse to the learning rate. None when
    the config does not cycle momentum (``mde_tpu/train/optim.py:41-68``)."""
    sched = opt.get("scheduler", {})
    if not bool(sched.get("cycle_momentum", False)):
        return None
    total = max(total_steps, 1)
    pct_start = float(sched.get("pct_start", 0.25))
    base_m = float(sched.get("base_momentum", 0.85))
    max_m = float(sched.get("max_momentum", 0.95))
    warm = max(pct_start * total, 1e-6)

    def schedule(count: int) -> float:
        count = min(count, total)
        warming = count < warm
        pct = count / warm if warming else (count - warm) / max(total - warm, 1e-6)
        cos_out = 0.5 * (1.0 + math.cos(math.pi * pct))
        if warming:
            return base_m + (max_m - base_m) * cos_out
        return max_m + (base_m - max_m) * cos_out

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    f32, on the tensors' device, outside autograd. On the CPU each tensor's
    norm is accumulated in f64: torch's CPU ``vector_norm`` sums f32 squares
    lane by lane and is 1e-4 low at 1e7 elements, 1e-3 at 4e7 (a Swin-L
    layer's gradient holds 9.4e6)."""
    def norm(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().float()
        return torch.linalg.vector_norm(
            t, dtype=torch.float64 if t.device.type == "cpu" else None).float()

    return torch.linalg.vector_norm(torch.stack([norm(t) for t in tensors]))


class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw)`` over ``params`` (name
    -> parameter), updating them in place; see the module docstring. It
    holds the first and second moments and the update count. The
    parameters named in ``no_update`` get neither (``zero_grad_bn``)."""

    def __init__(self, params: Dict[str, nn.Parameter], lr: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                 max_norm: float = 0.0, moment_dtype: torch.dtype = torch.float32,
                 b1_schedule: Optional[Schedule] = None, encoder_scale: float = 1.0,
                 no_update: Sequence[str] = ()):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.b1_schedule = b1_schedule
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.encoder_scale = encoder_scale
        self.names = [n for n in params if n not in set(no_update)]
        self.params = [params[n] for n in self.names]
        self.encoder = [i for i, n in enumerate(self.names) if "encoder" in n.split(".")]
        self.mu = [torch.zeros_like(p, dtype=moment_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """One step from ``grads`` (name -> gradient, every parameter)."""
        g = [grads[n].float() for n in self.names]
        if self.max_norm > 0:
            norm = global_norm(g)
            if not bool(norm < self.max_norm):
                g = torch._foreach_mul(torch._foreach_div(g, norm), self.max_norm)
        b1 = self.b1 if self.b1_schedule is None else self.b1_schedule(self.count)
        mu: List[torch.Tensor] = [m.float() for m in self.mu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.b2)
        t = self.count + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** t)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - self.b2 ** t))
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(u, -self.lr(self.count))
        if self.encoder_scale != 1.0 and self.encoder:
            torch._foreach_mul_([u[i] for i in self.encoder], self.encoder_scale)
        torch._foreach_add_(self.params, u)
        for stored, new in zip(self.mu, mu):
            if stored is not new:
                stored.copy_(new)
        self.count = t


def bn_parameter_names(model: nn.Module) -> List[str]:
    """The parameters of the BatchNorms (scale and bias): the leaves
    ``zero_grad_bn`` leaves alone (``mde_tpu/train/optim.py:85-99``)."""
    return [f"{name}.{p}" if name else p for name, m in model.named_modules()
            if isinstance(m, BatchNorm) for p, _ in m.named_parameters(recurse=False)]


def build_optimizer(opt, total_steps: int, model: nn.Module,
                    zero_grad_bn: bool = False) -> AdamW:
    """AdamW with the config's OneCycle schedule, global clip
    ``train.grad_norm``, ``optimizer.moment_dtype``, ``same_lr`` and
    ``scheduler.cycle_momentum``, over ``model``'s parameters."""
    o = opt["optimizer"]
    betas = o.get("betas", [0.9, 0.999])
    mu_dtype = o.get("moment_dtype", None)
    if mu_dtype not in _DTYPES:
        raise ValueError(f"Unsupported moment_dtype {mu_dtype!r}")
    return AdamW(
        dict(model.named_parameters()), build_lr_schedule(opt, total_steps),
        b1=float(betas[0]), b2=float(betas[1]), eps=float(o.get("eps", 1e-6)),
        weight_decay=float(o.get("weight_decay", 0.0)),
        max_norm=float(opt.get("train", {}).get("grad_norm", 0.0) or 0.0),
        moment_dtype=_DTYPES[mu_dtype],
        b1_schedule=build_momentum_schedule(opt, total_steps),
        encoder_scale=1.0 if o.get("same_lr", True) else 0.1,
        no_update=bn_parameter_names(model) if zero_grad_bn else ())
