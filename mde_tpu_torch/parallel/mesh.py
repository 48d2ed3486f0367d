"""The data-parallel group (``mde_tpu/parallel/mesh.py``), the torch way:
one process a card.

JAX runs one controller over a mesh whose ``data`` axis splits each batch
and replicates the parameters. Here each card has its own process (started
by ``torchrun``, or with an explicit rank, world size and store), the
processes form the data group, and each takes its rows of every batch:
the ranks' rows, in rank order, are the shards of JAX's data axis. NCCL
joins the processes on CUDA, gloo on the CPU. Where no process group is
started, the group is this one process and every collective
(``core/dist.py``) is the identity.

    torchrun --nproc_per_node 4 -m mde_tpu_torch.train.driver --opt x.json --bf16
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as tdist

from ..core import dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data group: ``rank`` of ``size``
    processes, computing on ``device``."""

    rank: int
    size: int
    device: torch.device


def make_mesh(device: Optional[Union[str, torch.device]] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, store: Optional[tdist.Store] = None) -> Mesh:
    """The data group of this process. Where no process group is live,
    one is started: from ``rank``, ``world_size`` and ``store`` where they
    are given, else from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), else none (a group of
    one). ``device`` (default CUDA) is this process's card (under
    ``torchrun`` the one of ``LOCAL_RANK`` where no index is given) or the
    CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.index is not None:
        torch.cuda.set_device(device)
    if not dist.live():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if world_size is not None:
            if rank is None or store is None:
                raise ValueError("a data group from arguments takes rank, world_size and store")
            tdist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        elif "WORLD_SIZE" in os.environ:
            tdist.init_process_group(backend, init_method="env://")
    return Mesh(dist.process_index(), dist.process_count(), device)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a host or device batch (a dict, tuple or list of
    arrays or tensors with the batch first): the ``mesh.rank``-th of
    ``mesh.size`` equal, consecutive parts. The batch must split evenly."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    if not isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch
    b = batch.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not split over {mesh.size} ranks")
    n = b // mesh.size
    return batch[mesh.rank * n:(mesh.rank + 1) * n]


@torch.no_grad()
def replicate(mesh: Mesh, state):
    """Rank 0's ``train.state.TrainState`` (the model's parameters and
    buffers, the optimizer's moments and counts), broadcast in place to
    every rank. Returns ``state``."""
    if mesh.size == 1:
        return state
    optimizer = state.optimizer
    for t in (*state.model.parameters(), *state.model.buffers(), *optimizer.mu, *optimizer.nu):
        tdist.broadcast(t.data, src=0)
    counts = [optimizer.count, state.step]
    tdist.broadcast_object_list(counts, src=0)
    optimizer.count, state.step = counts
    return state
