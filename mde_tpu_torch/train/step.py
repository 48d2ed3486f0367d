"""Train and eval steps (``mde_tpu/train/step.py``).

One train step: forward in training mode, loss, backward, gradient
accumulation over ``num_accum`` microbatches, the global clip and the AdamW
update, on the device the model lies on. BatchNorm statistics carry from
one microbatch to the next, and the gradients are averaged, as the JAX
step's scan does (``:155-192``). Two data-parallel steps run it across
the ranks of a data group: ``make_train_step_shard_map`` on each rank's
rows of the batch, averaging the gradients, the BatchNorm statistics and
the logs over the ranks before the update; ``make_train_step_gspmd`` on
the global batch, each rank its rows of every microbatch, with the
global batch's BatchNorm statistics, dropout masks and loss.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import dist
from ..core import metrics as M
from ..ops.mlp import tp_gather
from ..ops.resize import resize_bilinear
from ..ops.tnn import BatchNorm, bn_freeze_scope, encoder_only
from ..parallel.mesh import gspmd_scope, microbatch_rows
from .loss import DepthLoss
from .optim import global_norm
from .state import TrainState

ModelAdapter = Callable[..., Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]]

# families whose second output is bin edges, not centers (``:63``)
_EDGE_EMITTERS = frozenset({"adabins", "oda_bins", "depthformer_v3"})


def _depth_maps(value) -> bool:
    """Whether ``value`` is a non-empty tuple or list of (B, h, w, 1) maps."""
    return (isinstance(value, (tuple, list)) and len(value) > 0
            and all(getattr(m, "ndim", 0) == 4 and m.shape[-1] == 1 for m in value))


def default_adapter(model_out) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """A model's output -> (output maps, bin centers or None), for the
    contracts ``(pred, maps[, ...])`` (the ordered heads), ``(pred, aux,
    centers, attns)``, ``(pred, bins[, ...])`` and ``pred``. A second item
    is taken as maps only where each is a (B, h, w, 1) map: the attention
    weights that ``oda2_red_luna_reg`` returns there are 4-D too, and JAX's
    adapter (``mde_tpu/train/step.py:38-43``) hands them to the loss as
    maps; the port gives its loss the prediction."""
    if isinstance(model_out, tuple):
        if len(model_out) >= 2 and _depth_maps(model_out[1]):
            return tuple(model_out[1]), None
        if len(model_out) == 4 and getattr(model_out[2], "ndim", 0) == 2:
            return (model_out[0],), model_out[2]
        second = model_out[1] if len(model_out) >= 2 else None
        if second is not None and getattr(second, "ndim", 0) == 2:
            return (model_out[0],), second
        return (model_out[0],), None
    return (model_out,), None


def bin_edges_to_centers(edges: torch.Tensor) -> torch.Tensor:
    return 0.5 * (edges[:, :-1] + edges[:, 1:])


def make_adapter(model_name: str) -> ModelAdapter:
    """``default_adapter``, with bin edges turned into the centers that the
    chamfer loss takes for the families that emit edges."""
    def adapter(model_out):
        outs, bins = default_adapter(model_out)
        if bins is not None and model_name in _EDGE_EMITTERS:
            bins = bin_edges_to_centers(bins)
        return outs, bins
    return adapter


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(opt, min_depth: float, max_depth: float,
                    adapter: Optional[ModelAdapter] = None, num_accum: int = 1,
                    freeze_bn: bool = False, freeze_encoder_bn: bool = False):
    """Build ``step(state, batch, generator=None) -> (state, logs)``.

    ``batch`` holds ``image`` (B, H, W, 3) and ``depth`` (B, H, W, 1), f32
    arrays or tensors; B is split into ``num_accum`` microbatches. The step
    puts ``state.model`` in training mode and updates ``state`` in place:
    the parameters and BatchNorm statistics of the model, the optimizer's
    moments, the step count. ``generator`` (a ``torch.Generator`` on the
    model's device) feeds the stochastic depth. ``logs`` holds ``loss``,
    ``loss_si`` (and the other loss terms the config turns on), averaged
    over the microbatches, ``grad_norm`` (the averaged gradient's global
    norm before the clip) and ``param_norm`` (after the update), as 0-d
    tensors on the model's device.

    ``freeze_bn`` normalises every BatchNorm with its running statistics and
    leaves them unchanged (the reference's ``m.eval()`` freeze);
    ``freeze_encoder_bn`` does so for the encoder's only."""
    return _make_step(opt, min_depth, max_depth, adapter, num_accum, freeze_bn,
                      freeze_encoder_bn)


def _make_step(opt, min_depth: float, max_depth: float, adapter: Optional[ModelAdapter],
               num_accum: int, freeze_bn: bool, freeze_encoder_bn: bool, mesh=None,
               spmd: Optional[str] = None):
    """The train step; given the data group ``mesh``, the step of one of
    its ranks under ``spmd``: ``"shard_map"`` (``make_train_step_shard_map``)
    or ``"gspmd"`` (``make_train_step_gspmd``)."""
    if adapter is None:
        adapter = make_adapter(opt.get("model", {}).get("name", ""))
    depth_loss = DepthLoss(opt["loss"], min_depth, max_depth)
    predicate = (lambda path: True) if freeze_bn else (encoder_only if freeze_encoder_bn
                                                       else None)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        device = _model_device(model)
        if spmd == "shard_map":
            generator = _rank_generator(generator, mesh.rank, state.step)
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        depths = torch.as_tensor(batch["depth"], dtype=torch.float32, device=device)
        b = images.shape[0]
        if spmd == "gspmd":
            parts = [microbatch_rows(mesh, b, num_accum, m) for m in range(num_accum)]
        elif b % num_accum:
            raise ValueError(f"batch {b} does not split into {num_accum} microbatches")
        else:
            micro = b // num_accum
            parts = [slice(m * micro, (m + 1) * micro) for m in range(num_accum)]
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        # the backward pass, and any recompute in it, runs inside the freeze
        # and the global batch
        with (bn_freeze_scope(model, predicate) if predicate else contextlib.nullcontext()), \
                (gspmd_scope(mesh) if spmd == "gspmd" else contextlib.nullcontext()):
            for part in parts:
                outs, centers = adapter(model(images[part], generator=generator))
                loss, logs = depth_loss(outs, depths[part], bin_centers=centers)
                loss.backward()
                for key, value in logs.items():
                    sums[key] = sums[key] + value.detach() if key in sums else value.detach()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if num_accum > 1:
            grads = {n: g / num_accum for n, g in grads.items()}
        logs = {key: value / num_accum for key, value in sums.items()}
        if spmd == "shard_map":
            grads, logs = _rank_mean(model, grads, logs)
        elif spmd == "gspmd":
            grads = _gspmd_mean(model, mesh, grads)
        logs["grad_norm"] = global_norm(list(grads.values()))
        state.optimizer.update(grads)
        logs["param_norm"] = global_norm(list(params.values()))
        state.step += 1
        return state, logs

    return step


def _rank_generator(generator: Optional[torch.Generator], rank: int,
                    step: int) -> Optional[torch.Generator]:
    """The generator rank ``rank`` draws from in step ``step``: JAX folds
    the shard index into each step's key (``fold_in``). Rank 0 draws from
    the caller's generator, so that one rank steps as ``make_train_step``
    does; rank r > 0 from a generator seeded by the caller's seed, r and
    the step."""
    if generator is None or rank == 0:
        return generator
    seed = np.random.SeedSequence([generator.initial_seed(), rank, step])
    return torch.Generator(device=generator.device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def _rank_mean(model: nn.Module, grads: Dict[str, torch.Tensor],
               logs: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The mean over the ranks of the gradients, of every BatchNorm's
    running statistics (written back in place) and of the logs: JAX's
    ``pmean``s (``mde_tpu/train/step.py:276-282``), each set in one
    collective a dtype."""
    grads = dict(zip(grads, dist.all_reduce_tensors(list(grads.values()), "mean")))
    stats: List[torch.Tensor] = [t for m in model.modules() if isinstance(m, BatchNorm)
                                 for t in (m.running_mean, m.running_var)]
    with torch.no_grad():
        for t, mean in zip(stats, dist.all_reduce_tensors(stats, "mean")):
            t.copy_(mean)
    return grads, dist.all_reduce_dict(logs, "mean")


def _gspmd_mean(model: nn.Module, mesh, grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The GSPMD step's gradient. Each rank's gradient is the data
    group's size times its rows' part (every rank backpropagates the
    global loss, and each sum over the ranks sums the gradients back):
    the mean over the ranks is the gradient. Under a model axis the ranks
    of a model group hold the same replicated gradients (up to the order
    of the card's atomic sums: the mean over every rank leaves them the
    same bits), and the tensor-parallel FFs' sliced parameters hold this
    rank's slice (zeros elsewhere): their sum over every rank, divided by
    the data group's size, is the gradient; the slices' running statistics
    are put together too (``ops.mlp.tp_gather``)."""
    sliced, whole = tp_gather(model, mesh, grads)
    out = dict(zip(whole, dist.all_reduce_tensors([grads[n] for n in whole], "mean")))
    if sliced:
        summed = dist.all_reduce_tensors([grads[n] for n in sliced], "sum")
        out.update((n, g / mesh.size) for n, g in zip(sliced, summed))
    return {n: out[n] for n in grads}


def make_train_step_shard_map(opt, min_depth: float, max_depth: float, mesh,
                              adapter: Optional[ModelAdapter] = None, num_accum: int = 1,
                              freeze_bn: bool = False, freeze_encoder_bn: bool = False):
    """The data-parallel train step (``mde_tpu/train/step.py:197-300``):
    ``step(state, batch, generator=None) -> (state, logs)`` on every rank
    of ``mesh`` (``parallel.mesh.make_mesh``), ``batch`` that rank's rows
    (``parallel.mesh.shard_batch``) and ``state`` the same on every rank
    (``parallel.mesh.replicate``).

    Each rank runs its rows as ``make_train_step`` runs a batch, in
    ``num_accum`` microbatches, drawing its dropout and stochastic depth
    from a generator of its own (``_rank_generator``); then the gradients,
    the BatchNorm running statistics and the logs are averaged over the
    ranks and every rank takes the same clipped AdamW update. BatchNorm
    normalises with each rank's own batch statistics, as torch's DDP
    without SyncBN and JAX's ``shard_map`` step do. ``grad_norm`` is the
    averaged gradient's norm, ``param_norm`` the new parameters'; the
    freezes act as in ``make_train_step``. With one rank it is
    ``make_train_step``."""
    return _make_step(opt, min_depth, max_depth, adapter, num_accum, freeze_bn,
                      freeze_encoder_bn, mesh, "shard_map")


def make_train_step_gspmd(opt, min_depth: float, max_depth: float, mesh,
                          adapter: Optional[ModelAdapter] = None, num_accum: int = 1,
                          freeze_bn: bool = False, freeze_encoder_bn: bool = False):
    """JAX's default data-parallel train step (``train.spmd`` ``"gspmd"``,
    ``mde_tpu/train/step.py:81-194`` on global arrays over a data mesh):
    ``step(state, batch, generator=None) -> (state, logs)`` on every rank
    of ``mesh`` (``parallel.mesh.make_mesh``), ``batch`` the whole step
    batch on every rank and ``state`` the same on every rank
    (``parallel.mesh.replicate``).

    Its numbers are ``make_train_step``'s on the global batch, up to the
    order of sums. The batch splits into ``num_accum`` microbatches of
    consecutive rows and each microbatch over the ranks
    (``parallel.mesh.microbatch_rows``; raises where one does not split);
    each rank runs its rows inside ``parallel.mesh.gspmd_scope``: BatchNorm
    normalises with the global batch's statistics, from which every rank
    updates the same running statistics; each dropout and stochastic-depth
    mask is the rank's rows of the global mask, drawn from ``generator`` in
    the same state on every rank; the losses and logs are the global
    batch's. Every rank backpropagates the global loss, each collective's
    backward sums the gradients over the ranks, and the parameters'
    gradients are averaged over the ranks before the same clipped AdamW
    update on every rank. ``grad_norm`` is the averaged gradient's norm,
    ``param_norm`` the new parameters'. With one process and no group it
    is ``make_train_step``."""
    return _make_step(opt, min_depth, max_depth, adapter, num_accum, freeze_bn,
                      freeze_encoder_bn, mesh, "gspmd")


def make_eval_step(model: nn.Module, opt, min_depth_eval: float, max_depth_eval: float,
                   data_type: str = "KITTI", flip_eval: bool = False):
    """Build ``eval_step(batch) -> metrics``: ``model`` in eval mode (the
    step puts it there), its prediction averaged with that of the mirrored
    images when ``flip_eval``, resized to the ground truth with
    align_corners, clipped to [min_depth_eval, max_depth_eval], and the
    per-image metrics (each a (B,) tensor) over the pixels that are valid
    and inside the config's eval crop (``mde_tpu/train/step.py:324-361``)."""
    opt_eval = opt["eval"]
    crops: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def crop_mask(gt_hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
        """The eval crop of a ground-truth shape on ``device``, copied there
        once: a copy from the host each batch would wait for the card."""
        if (*gt_hw, device) not in crops:
            crops[(*gt_hw, device)] = torch.from_numpy(
                M.eval_mask(opt_eval, gt_hw, data_type)).to(device)
        return crops[(*gt_hw, device)]

    def predict(images: torch.Tensor) -> torch.Tensor:
        pred = model(images)
        return pred[0] if isinstance(pred, tuple) else pred

    @torch.no_grad()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        device = _model_device(model)
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        depths = torch.as_tensor(batch["depth"], dtype=torch.float32, device=device)
        model.eval()
        pred = predict(images)
        if flip_eval:
            pred = 0.5 * (pred + predict(images.flip(2)).flip(2))
        gt_hw = (int(depths.shape[1]), int(depths.shape[2]))
        pred = resize_bilinear(pred, gt_hw, align_corners=True)
        pred = pred.clamp(min_depth_eval, max_depth_eval)
        valid = (depths > min_depth_eval) & (depths < max_depth_eval)
        crop = crop_mask(gt_hw, device)
        return M.compute_errors_per_image(depths, pred, valid & crop[None, :, :, None])

    return eval_step
