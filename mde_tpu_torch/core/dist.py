"""Process helpers of the driver (``mde_tpu/core/dist.py:86-100``): which
process logs and checkpoints. Rank 0 of ``torch.distributed`` when a process
group is initialised, else the one process there is."""

from __future__ import annotations

import torch.distributed as tdist


def is_primary() -> bool:
    """Rank-0 guard for logging and checkpointing (the reference's
    ``local_rank == 0``)."""
    return not (tdist.is_available() and tdist.is_initialized()) or tdist.get_rank() == 0


def dprint(*args, force: bool = False, **kwargs) -> None:
    """Print on the primary process only (reference ``utils/common_utils.py:55-57``)."""
    if force or is_primary():
        print(*args, **kwargs)
