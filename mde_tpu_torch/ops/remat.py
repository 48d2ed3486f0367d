"""Recompute of checkpointed blocks (``mde_tpu/ops/remat.py``).

The ``full`` policy (``MDE_REMAT_POLICY=full`` in the JAX package,
``:52-54``): a checkpointed block keeps only its inputs, and its forward
runs again in the backward pass. The JAX package's default, selective
``save_sa_conv`` policy (saving attention and depthwise-conv outputs) is not
ported yet (ROADMAP.md).

Two things a recompute must not change: the random masks, which the caller
draws outside the block and passes in (``ops/drop.py``), and the BatchNorm
running statistics, which the first forward already updated: while the
block replays, its BatchNorms use batch statistics without updating them.
"""

from __future__ import annotations

import contextlib

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


def checkpoint(block: nn.Module, *args):
    """``block(*args)``, recomputed in the backward pass instead of keeping
    its activations (``torch.utils.checkpoint``, non-reentrant)."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _replaying(block)))
