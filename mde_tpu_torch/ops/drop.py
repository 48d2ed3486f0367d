"""Stochastic depth and dropout (``mde_tpu/ops/drop.py``, flax's
``nn.Dropout``), drawing from an explicit ``torch.Generator``.

A module draws its random keep mask in :meth:`DropPath.draw`, apart from
applying it, so that a checkpointed block can draw its masks once outside
the recomputed function and hand the same masks to the recompute
(``torch.utils.checkpoint`` replays only the global RNG states, never a
user's generator). The two frameworks draw different bits from one seed:
the tests compare the numerics with the rates at 0 or with shared masks.

Inside a global-batch scope (``parallel.mesh.gspmd_scope``) a mask is
this rank's rows of the mask of the global batch: every rank draws the
global mask from the same generator, in the same state, and keeps its
rows, so the generator advances as it does in one process and the ranks'
rows together are that process's mask (JAX draws each mask for the
global array). A mask with no batch dimension (``batched=False``) is the
same on every rank. The global draw holds an f32 of every element of the
global batch's mask for a moment, where the rank's own rows would need
1 / ranks of it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dist


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator],
               device: torch.device, batched: bool = True) -> torch.Tensor:
    """A boolean mask, True with probability 1 - rate, drawn on the
    generator's device and moved to ``device``. Inside a global-batch
    scope, a ``batched`` mask (batch-major leading dimension) is this
    rank's rows of the global batch's mask."""
    gen_device = generator.device if generator is not None else device
    scope = dist.global_batch() if batched else None
    if scope is None:
        return (torch.rand(shape, generator=generator, device=gen_device) >= rate).to(device)
    n = shape[0]
    draw = torch.rand((n * scope.size, *shape[1:]), generator=generator, device=gen_device)
    return (draw[scope.rank * n:(scope.rank + 1) * n] >= rate).to(device)


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
    probability ``keep = 1 - rate`` and divided by ``keep`` rounded to its
    dtype (flax divides by the weak-typed scalar), or zeroed; the identity
    in eval mode or at rate 0. ``keep`` is filled on x's device, so the
    division is a true one there too (a host scalar would make CUDA
    multiply by its f32 reciprocal) and no copy waits on the host.
    ``batched`` False marks an input whose leading dimension is not the
    batch's: its mask is drawn whole on every rank of a global batch."""

    def __init__(self, rate: float = 0.0, batched: bool = True):
        super().__init__()
        self.rate = rate
        self.batched = batched

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        keep = _keep_mask(x.shape, self.rate, generator, x.device, self.batched)
        keep_prob = torch.full((), 1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
