"""Recompute of checkpointed blocks (``mde_tpu/ops/remat.py``).

The ``full`` policy (``MDE_REMAT_POLICY=full`` in the JAX package,
``:52-54``): a checkpointed block keeps only its inputs, and its forward
runs again in the backward pass. The JAX package's default, selective
``save_sa_conv`` policy (saving attention and depthwise-conv outputs) is not
ported yet (ROADMAP.md).

Two things a recompute must not change: the random masks, and the
BatchNorm running statistics, which the first forward already updated:
while the block replays, its BatchNorms use batch statistics without
updating them. A caller draws per-sample masks outside the block and
passes them in (``ops/drop.py``); a block that draws element-wise dropout
masks from a ``generator`` draws them from a copy of the generator's
state, taken before the block, both times (``torch.utils.checkpoint``
replays only the global RNG states, never a user's generator).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from .tnn import BatchNorm


@contextlib.contextmanager
def _replaying(block: nn.Module):
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.replaying = True
    try:
        yield
    finally:
        for m in norms:
            m.replaying = False


def checkpoint(block: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """``block(*args)``, or ``block(*args, generator)`` where a generator is
    given, recomputed in the backward pass instead of keeping its
    activations (``torch.utils.checkpoint``, non-reentrant). The first
    forward leaves ``generator`` where the block left it; the recompute
    draws the same bits from the saved state and leaves it alone."""
    fn = block
    if generator is not None:
        state, first = generator.get_state(), [True]

        def fn(*a):
            g = torch.Generator(device=generator.device)
            g.set_state(state)
            out = block(*a, g)
            if first:
                generator.set_state(g.get_state())
                first.clear()
            return out
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _replaying(block)))
