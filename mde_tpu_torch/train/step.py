"""Train and eval steps (``mde_tpu/train/step.py``).

One train step: forward in training mode, loss, backward, gradient
accumulation over ``num_accum`` microbatches, the global clip and the AdamW
update, on the device the model lies on. BatchNorm statistics carry from
one microbatch to the next, and the gradients are averaged, as the JAX
step's scan does (``:155-192``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core import metrics as M
from ..ops.resize import resize_bilinear
from ..ops.tnn import bn_freeze_scope, encoder_only
from .loss import DepthLoss
from .optim import global_norm
from .state import TrainState

ModelAdapter = Callable[..., Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]]

# families whose second output is bin edges, not centers (``:63``)
_EDGE_EMITTERS = frozenset({"adabins", "oda_bins", "depthformer_v3"})


def default_adapter(model_out) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """A model's output -> (output maps, bin centers or None), for the
    contracts ``(pred, maps[, ...])`` (the ordered heads), ``(pred, aux,
    centers, attns)``, ``(pred, bins[, ...])`` and ``pred``."""
    if isinstance(model_out, tuple):
        if (len(model_out) >= 2 and isinstance(model_out[1], (tuple, list))
                and len(model_out[1]) > 0 and getattr(model_out[1][0], "ndim", 0) == 4):
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
    if adapter is None:
        adapter = make_adapter(opt.get("model", {}).get("name", ""))
    depth_loss = DepthLoss(opt["loss"], min_depth, max_depth)
    predicate = (lambda path: True) if freeze_bn else (encoder_only if freeze_encoder_bn
                                                       else None)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        device = _model_device(model)
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        depths = torch.as_tensor(batch["depth"], dtype=torch.float32, device=device)
        b = images.shape[0]
        if b % num_accum:
            raise ValueError(f"batch {b} does not split into {num_accum} microbatches")
        micro = b // num_accum
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        # the backward pass, and any recompute in it, runs inside the freeze
        with (bn_freeze_scope(model, predicate) if predicate else contextlib.nullcontext()):
            for m in range(num_accum):
                part = slice(m * micro, (m + 1) * micro)
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
        logs["grad_norm"] = global_norm(list(grads.values()))
        state.optimizer.update(grads)
        logs["param_norm"] = global_norm(list(params.values()))
        state.step += 1
        return state, logs

    return step


def make_eval_step(model: nn.Module, opt, min_depth_eval: float, max_depth_eval: float,
                   data_type: str = "KITTI", flip_eval: bool = False):
    """Build ``eval_step(batch) -> metrics``: ``model`` in eval mode (the
    step puts it there), its prediction averaged with that of the mirrored
    images when ``flip_eval``, resized to the ground truth with
    align_corners, clipped to [min_depth_eval, max_depth_eval], and the
    per-image metrics (each a (B,) tensor) over the pixels that are valid
    and inside the config's eval crop (``mde_tpu/train/step.py:324-361``)."""
    opt_eval = opt["eval"]

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
        crop = torch.from_numpy(M.eval_mask(opt_eval, gt_hw, data_type)).to(device)
        return M.compute_errors_per_image(depths, pred, valid & crop[None, :, :, None])

    return eval_step
