"""Stochastic depth, and the guard on what this slice of the port leaves out.

Only the eval-mode forward is ported: training mode (batch statistics,
dropout, drop-path) comes with the training slice, ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import torch
from torch import nn

TRAINING_ITEM = "ROADMAP.md Queue 1, item 5 (the training slice)"


def require_eval(module: nn.Module) -> None:
    """Raise NotImplementedError when ``module`` is in training mode."""
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: training mode is not ported yet "
            f"({TRAINING_ITEM}); call .eval()")


class DropPath(nn.Module):
    """Per-sample residual-branch dropout (``mde_tpu/ops/drop.py``): the
    identity at eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate > 0:
            require_eval(self)
        return x
