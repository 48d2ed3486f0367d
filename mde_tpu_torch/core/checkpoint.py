"""Native checkpoints of the port (``mde_tpu/core/checkpoint.py:37-84``),
written with ``torch.save`` where the JAX package uses orbax.

``save_checkpoint`` writes ``<ckpt_dir>/step_<N>/`` holding ``model.pt``
(the model's ``state_dict``: parameters and BatchNorm statistics),
``optimizer.pt`` (the optimizer's moments ``mu``, ``nu`` and its ``count``,
with the parameter names they belong to) and ``meta.json`` (``step``,
``best_value``), and keeps the newest ``keep`` of them. Weights from the
JAX package come across by ``convert.from_jax_variables``, not through
these files.

Reference checkpoints (``mde_tpu/core/checkpoint.py:87-271``): the port's
modules take the reference's state-dict names, so a released full-model
file (AdaBins, NewCRFs) loads with ``load_state_dict(strict=True)`` once
:func:`load_torch_state_dict` has read it and :func:`load_reference_model`
has left out the buffers the reference derives from its window size. A
Microsoft Swin ImageNet file becomes a ``SwinTransformer`` state dict
through :func:`swin_backbone_state_dict`, which consumes every key or
fails, as JAX's ``KeyAccountant`` does.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..train.state import TrainState

_STEP = re.compile(r"step_(\d+)")


def _steps(ckpt_dir: str):
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _STEP.fullmatch(name)))


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    best_value: Optional[float] = None, keep: int = 3) -> str:
    """Save ``state`` (and the bookkeeping) under ``ckpt_dir/step_<N>``."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    opt = state.optimizer
    torch.save(state.model.state_dict(), os.path.join(path, "model.pt"))
    torch.save({"names": list(opt.names), "mu": list(opt.mu), "nu": list(opt.nu),
                "count": opt.count}, os.path.join(path, "optimizer.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "best_value": best_value or 0.0}, f)
    _gc_checkpoints(ckpt_dir, keep)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]}") if steps else None


def restore_checkpoint(path: str, state: TrainState) -> Dict:
    """Load ``path`` into ``state`` in place, onto its model's device: the
    parameters, BatchNorm statistics, moments, update count and step.
    Returns the bookkeeping (``step``, ``best_value``)."""
    device = next(state.model.parameters()).device
    model = torch.load(os.path.join(path, "model.pt"), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(model)
    saved = torch.load(os.path.join(path, "optimizer.pt"), map_location=device,
                       weights_only=True)
    opt = state.optimizer
    if saved["names"] != opt.names:
        raise ValueError(f"{path}: the optimizer holds moments of other parameters")
    with torch.no_grad():
        for stored, value in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"]):
            stored.copy_(value)
    opt.count = int(saved["count"])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state.step = int(meta["step"])
    return meta


def _gc_checkpoints(ckpt_dir: str, keep: int) -> None:
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


# buffers the reference's Swin blocks derive from their window size; the port
# computes them (``ops.attention.relative_position_index``,
# ``ops.window.shifted_window_attn_mask``) and JAX's converters skip them
_DERIVED = re.compile(r"(^|\.)(relative_position_index|attn_mask|relative_coords_table)$")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` file on the CPU: under ``model`` or
    ``state_dict`` where the file nests them there (Microsoft's Swin,
    training checkpoints), ``module.`` prefixes (DDP) stripped, entries
    that are not tensors left out (``mde_tpu/core/checkpoint.py:87-104``,
    which returns numpy arrays)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "state_dict"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    return {(k[len("module."):] if k.startswith("module.") else k): v.detach()
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_reference_model(model: nn.Module, path: str) -> nn.Module:
    """Load a reference full-model checkpoint (``.pth``: AdaBins, NewCRFs)
    into ``model`` with ``strict=True``, less the buffers derived from the
    window size, which the port computes itself. Returns ``model``."""
    state = {k: v for k, v in load_torch_state_dict(path).items() if not _DERIVED.search(k)}
    model.load_state_dict(state, strict=True)
    return model


def interpolate_rel_pos_bias(table: torch.Tensor, new_window: int) -> torch.Tensor:
    """A ((2w - 1)^2, heads) relative-position bias table resized bicubically
    to window ``new_window`` (``mde_tpu/core/checkpoint.py:107-122``;
    reference ``newcrf_utils.py:245-260``); the table itself where the
    window is unchanged."""
    l_old, nh = table.shape
    s_old = int(round(l_old ** 0.5))
    s_new = 2 * new_window - 1
    if s_old * s_old != l_old:
        raise ValueError(f"Table length {l_old} is not square.")
    if s_old == s_new:
        return table
    t = table.float().permute(1, 0).reshape(1, nh, s_old, s_old)
    t = F.interpolate(t, size=(s_new, s_new), mode="bicubic")
    return t.reshape(nh, s_new * s_new).permute(1, 0).contiguous()


def swin_backbone_state_dict(torch_state: Dict[str, torch.Tensor],
                             depths: Sequence[int] = (2, 2, 18, 2),
                             out_indices: Sequence[int] = (0, 1, 2, 3),
                             target_window: Optional[int] = None,
                             take_out_norms: bool = False) -> Dict[str, torch.Tensor]:
    """A Microsoft Swin(-B/L 22k) ImageNet state dict -> the state dict of
    the port's ``SwinTransformer(depths=..., out_indices=...)``, the
    counterpart of ``convert_swin_backbone`` (``mde_tpu/core/checkpoint.py:222-271``):
    the classifier's ``head`` and ``norm``, ``attn_mask`` and
    ``relative_position_index`` are dropped, every relative-position table
    is resized to ``target_window`` where one is given, and each output
    norm ``norm{i}`` is the identity (weight 1, bias 0) unless
    ``take_out_norms`` (a full-model file whose ``norm{i}`` were trained).
    Every other key must be consumed: a missing one raises ``KeyError``,
    one left over ``ValueError``."""
    used = set()
    skipped = {k for k in torch_state
               if re.fullmatch(r"(norm|head)\.(weight|bias)", k)
               or re.search(r"attn_mask|relative_position_index", k)}
    out: Dict[str, torch.Tensor] = {}

    def take(key: str) -> torch.Tensor:
        if key not in torch_state:
            raise KeyError(f"Missing torch key: {key}")
        used.add(key)
        out[key] = torch_state[key]
        return out[key]

    for name in ("patch_embed.proj.weight", "patch_embed.proj.bias",
                 "patch_embed.norm.weight", "patch_embed.norm.bias"):
        take(name)
    for i, depth in enumerate(depths):
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            table = take(f"{p}.attn.relative_position_bias_table")
            if target_window is not None:
                out[f"{p}.attn.relative_position_bias_table"] = interpolate_rel_pos_bias(
                    table, target_window)
            for part in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
                take(f"{p}.{part}.weight")
                take(f"{p}.{part}.bias")
        if i < len(depths) - 1:
            take(f"layers.{i}.downsample.norm.weight")
            take(f"layers.{i}.downsample.norm.bias")
            take(f"layers.{i}.downsample.reduction.weight")
    embed_dim = out["patch_embed.proj.weight"].shape[0]
    for i in out_indices:
        if take_out_norms:
            take(f"norm{i}.weight")
            take(f"norm{i}.bias")
        else:
            # fresh identity output norms (the reference fills 1 and 0)
            dim = embed_dim * 2 ** i
            out[f"norm{i}.weight"] = torch.ones(dim)
            out[f"norm{i}.bias"] = torch.zeros(dim)
    left = sorted(set(torch_state) - used - skipped)
    if left:
        raise ValueError(f"Unconverted torch keys ({len(left)}): {left[:10]}...")
    return out
