"""Native checkpoints of the port (``mde_tpu/core/checkpoint.py:37-84``),
written with ``torch.save`` where the JAX package uses orbax.

``save_checkpoint`` writes ``<ckpt_dir>/step_<N>/`` holding ``model.pt``
(the model's ``state_dict``: parameters and BatchNorm statistics),
``optimizer.pt`` (the optimizer's moments ``mu``, ``nu`` and its ``count``,
with the parameter names they belong to) and ``meta.json`` (``step``,
``best_value``), and keeps the newest ``keep`` of them. Weights from the
JAX package come across by ``convert.from_jax_variables``, not through
these files.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import torch

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
