"""Collectives and process helpers over ``torch.distributed``
(``mde_tpu/core/dist.py``).

JAX's collectives act inside a mapped computation that binds the data
axis and are the identity outside one. Here the data axis is a process
group, one process a card (``parallel/mesh.py``): each collective acts
across the processes of ``group`` (the default group where it is None)
and is the identity where no process group is live, so that every code
path runs in one process. A collective leaves its input as it is, as
JAX's do.

JAX's GSPMD step computes on global arrays: a BatchNorm's statistics, a
loss's means and a dropout mask are those of the whole batch, whatever
device holds each row. The port's ``train.spmd`` ``"gspmd"`` step opens a
global-batch scope (``parallel.mesh.gspmd_scope``) around its forward and
backward passes: inside it, :func:`global_batch` names this rank's place
in the data group, and the modules take their batch-wide sums through
:func:`sum_over_ranks`, whose backward sums the gradients over the ranks
too. ``collective_counts`` counts this process's all-reduce launches.

Under a (data, model) mesh (``parallel.mesh.make_mesh(..., n_model=n)``)
the batch-wide sums go over the data group (``Mesh.data_group``), and a
tensor-parallel feed-forward (``ops/mlp.PreNormDWConvFF`` with
``tp_axis``) joins its channel slices over the model group:
:func:`copy_to_model` at its input (its backward sums the slices'
gradients) and :func:`sum_over_model` at its output (the partial products
summed; its backward hands each rank the whole gradient).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import torch
import torch.distributed as tdist

if TYPE_CHECKING:
    from ..parallel.mesh import Mesh

_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT"}

# all-reduce launches of this process since the last reset
collective_counts = {"all_reduce": 0}


def reset_collective_counts() -> None:
    collective_counts["all_reduce"] = 0


# the data group of the open global-batch scope; not thread-local, as the
# backward pass (and the recompute in it) of CUDA tensors runs in
# autograd's own threads
_global_batch: List[Optional["Mesh"]] = [None]


def global_batch() -> Optional["Mesh"]:
    """While a global-batch scope is open (``parallel.mesh.gspmd_scope``),
    the data group whose ranks' rows, in rank order, make the global
    batch: this rank's ``rank`` of ``size``; else None."""
    return _global_batch[0]


def set_global_batch(mesh: Optional["Mesh"]) -> Optional["Mesh"]:
    """Open the global-batch scope of ``mesh`` (close it, given None);
    returns the group of the scope it replaces."""
    old, _global_batch[0] = _global_batch[0], mesh
    return old


def live() -> bool:
    """Whether a process group is live in this process."""
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    """This process's rank, 0 where no process group is live."""
    return tdist.get_rank() if live() else 0


def process_count(group=None) -> int:
    """The processes of ``group``, 1 where no process group is live."""
    return tdist.get_world_size(group) if live() else 1


def _reduce_op(op: str):
    if op not in _OPS:
        raise ValueError(f"Unsupported reduce op {op}.")
    return getattr(tdist.ReduceOp, _OPS[op])


def all_reduce_tensors(tensors: Sequence[torch.Tensor], op: str = "sum",
                       group=None) -> List[torch.Tensor]:
    """``all_reduce_tensor`` of each tensor, in one collective for the
    tensors of each dtype (their values copied into one flat buffer)."""
    reduce_op = _reduce_op(op)
    if not live():
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    n = process_count(group)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        tdist.all_reduce(flat, op=reduce_op, group=group)
        collective_counts["all_reduce"] += 1
        if op == "mean":
            flat = flat / n
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def all_reduce_tensor(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Reduction across the group's processes: sum, mean, max, min or
    product (reference ``all_reduce_tensor``, ``dist_utils.py:49-64``)."""
    return all_reduce_tensors([x], op, group)[0]


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce_tensors`` (sum) whose backward sums each output's
    gradient over the ranks, in one collective a dtype too."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(all_reduce_tensors(tensors, "sum", group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_tensors(grads, "sum", ctx.group))


def sum_over_ranks(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The sum over the group's ranks of each tensor, in one collective a
    dtype (a live group of one included), differentiable: the gradient of
    each input is the sum over the ranks of its output's gradient. Where
    every rank backpropagates the same loss, as in the GSPMD step, each
    rank's input so gets the gradient that all ranks' uses of the sum give
    it (torch's ``SyncBatchNorm`` convention). The identity where no
    process group is live."""
    if not live():
        return list(tensors)
    return list(_SumOverRanks.apply(group, *tensors))


def _scalar_device(group=None) -> torch.device:
    """Where a collective of the group takes a host value: NCCL reduces
    tensors on the card, gloo on the host."""
    if live() and tdist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_scalar(value, op: str = "sum", group=None) -> torch.Tensor:
    """A Python or 0-d value reduced across the group (reference
    ``all_reduce_scalar``, ``dist_utils.py:15-46``), as a 0-d tensor."""
    return all_reduce_tensor(torch.as_tensor(value, device=_scalar_device(group)), op, group)


def all_reduce_dict(d: Dict[str, torch.Tensor], op: str = "mean",
                    group=None) -> Dict[str, torch.Tensor]:
    """Every value of a (metric) dict reduced (reference
    ``dist_utils.py:67-76``), in one collective a dtype."""
    return dict(zip(d, all_reduce_tensors(list(d.values()), op, group)))


def all_gather_tensor(x: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """Every process's ``x`` concatenated along ``axis`` in rank order
    (reference ``all_gather_tensor``, ``dist_utils.py:79-89``)."""
    if not live():
        return x
    parts = [torch.empty_like(x) for _ in range(process_count(group))]
    tdist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def is_primary() -> bool:
    """Rank-0 guard for logging and checkpointing (the reference's
    ``local_rank == 0``)."""
    return process_index() == 0


def dprint(*args, force: bool = False, **kwargs) -> None:
    """Print on the primary process only (reference ``utils/common_utils.py:55-57``)."""
    if force or is_primary():
        print(*args, **kwargs)


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group; backward the identity: every rank of
    the group uses the whole sum and backpropagates the same gradient,
    which is each rank's partial's gradient."""

    @staticmethod
    def forward(ctx, group, x):
        return all_reduce_tensors([x], "sum", group)[0]

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _CopyToModel(torch.autograd.Function):
    """The identity; backward the sum over the model group of the
    gradients, one from each rank's channel slice."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, all_reduce_tensors([grad], "sum", ctx.group)[0]


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``x`` (one
    collective), whose gradient is handed back whole to every rank's
    partial (Megatron's row-parallel output)."""
    return _SumOverModel.apply(group, x)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over the model group (one
    collective in the backward pass): the input of a layer each rank of
    the group computes a slice of (Megatron's column-parallel input)."""
    return _CopyToModel.apply(group, x)
