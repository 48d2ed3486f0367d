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

Under ``train.spmd`` ``"gspmd"`` the ranks' rows make one global batch:
each rank takes its rows of every microbatch (:func:`microbatch_rows`),
and inside :func:`gspmd_scope` the modules compute what JAX computes on
the global arrays (BatchNorm statistics, dropout masks, the loss).

    torchrun --nproc_per_node 4 -m mde_tpu_torch.train.driver --opt x.json --bf16
"""

from __future__ import annotations

import contextlib
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


def microbatch_rows(mesh: Mesh, batch_size: int, num_accum: int, index: int) -> slice:
    """This rank's rows of microbatch ``index`` of a step batch of
    ``batch_size`` rows: JAX's GSPMD step splits the global batch into
    ``num_accum`` consecutive microbatches (``mde_tpu/train/step.py:164-166``)
    and its data axis each microbatch into ``mesh.size`` consecutive parts,
    the ``mesh.rank``-th of which is this rank's. Raises where the batch
    does not split into the microbatches, or a microbatch over the ranks."""
    if batch_size % num_accum:
        raise ValueError(f"batch {batch_size} does not split into {num_accum} microbatches")
    micro = batch_size // num_accum
    if micro % mesh.size:
        raise ValueError(f"a microbatch of {micro} images (batch {batch_size} in {num_accum}) "
                         f"does not split over {mesh.size} ranks")
    n = micro // mesh.size
    start = index * micro + mesh.rank * n
    return slice(start, start + n)


@contextlib.contextmanager
def gspmd_scope(mesh: Mesh):
    """While active, and where a process group is live, the modules treat
    each tensor's rows as this rank's part of a global batch (JAX's GSPMD
    arrays): BatchNorm takes its statistics over the global batch
    (``ops/tnn.py``), a dropout or stochastic-depth mask is this rank's
    rows of the global mask drawn from the same generator (``ops/drop.py``)
    and the losses are the global batch's (``train/loss.py``). The
    forward, the backward and every recompute in it must run inside the
    scope, on every rank alike: each rank launches the same collectives in
    the same order. Without a live group it changes nothing."""
    old = dist.set_global_batch(mesh if dist.live() else None)
    try:
        yield
    finally:
        dist.set_global_batch(old)


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
