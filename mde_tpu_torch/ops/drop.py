"""Stochastic depth and dropout (``mde_tpu/ops/drop.py``, flax's
``nn.Dropout``), drawing from an explicit ``torch.Generator``.

A module draws its random keep mask in :meth:`DropPath.draw`, apart from
applying it, so that a checkpointed block can draw its masks once outside
the recomputed function and hand the same masks to the recompute
(``torch.utils.checkpoint`` replays only the global RNG states, never a
user's generator). The two frameworks draw different bits from one seed:
the tests compare the numerics with the rates at 0 or with shared masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """A boolean mask, True with probability 1 - rate, drawn on the
    generator's device and moved to ``device``."""
    gen_device = generator.device if generator is not None else device
    return (torch.rand(shape, generator=generator, device=gen_device) >= rate).to(device)


class DropPath(nn.Module):
    """Per-sample residual-branch dropout (timm's DropPath, JAX's
    ``DropPath``): in training, each sample's branch is kept with probability
    ``keep = 1 - rate`` and then divided by ``keep`` in the branch's dtype,
    or zeroed; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, batch: int, generator: Optional[torch.Generator],
             device: torch.device) -> Optional[torch.Tensor]:
        """The (batch,) boolean keep mask of one call, or None where the
        module is the identity."""
        if not self.training or self.rate == 0:
            return None
        return _keep_mask((batch,), self.rate, generator, device)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return x
        keep_prob = (1.0 - torch.tensor(self.rate, dtype=torch.float32)).to(x.dtype)
        mask = keep.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep_prob.to(x.device), torch.zeros((), dtype=x.dtype,
                                                                           device=x.device))


class Dropout(nn.Module):
    """Element-wise dropout as flax's ``nn.Dropout``: each element kept with
    probability ``1 - rate`` and divided by it, or zeroed; the identity in
    eval mode or at rate 0 (every rate on the flagship's path is 0)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        keep = _keep_mask(x.shape, self.rate, generator, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))
