"""Train state (``mde_tpu/train/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from .optim import AdamW, build_optimizer


@dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    (its moments and update count) and the step count. Unlike JAX's
    immutable state, the train step updates all three in place and returns
    the same object."""

    model: nn.Module
    optimizer: AdamW
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, opt, total_steps: int,
               zero_grad_bn: bool = False) -> "TrainState":
        return cls(model, build_optimizer(opt, total_steps, model, zero_grad_bn))
