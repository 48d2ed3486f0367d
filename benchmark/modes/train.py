"""Training: the step of ``mde_tpu_torch.train.step.make_train_step`` with
``train.state.TrainState`` and ``train.optim.build_optimizer``, back to
back on a pool of distinct batches staged on the card, stochastic depth
and dropout drawn from a generator seeded from ``--seed``.

Set-up builds the one train state and drives it through the window's own
call and feed for the first ``check_steps`` steps, on pool batches 0, 1,
2; it keeps each step's loss, the first gradient as the optimizer took it
(its first moment after one step over 1 - b1) and, after the last of
them, how far each parameter and BatchNorm statistic moved. The window
goes on with the same state. After the window the reference follows the
same steps in float32 from the same weights, batches and masks, and the
numbers compare:

- ``loss_gap``: a step's loss, relative to the reference's;
- ``grad_gap``: a parameter's first-gradient norm against the
  reference's, over the larger of that norm and the median parameter's;
- ``change_gap``: the same of each parameter's change, over the
  parameters whose reference gradient is at least a thousandth of the
  median's (the rest move under Adam by round-off alone);
- ``change_median_gap``: the median parameter's ``change_gap``, steadier
  from seed to seed than the worst;
- ``bn_gap``: the same as ``change_gap`` of each BatchNorm running
  statistic's change.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import harness, inputs, reference
from ..reference.layers import Numerics, strict_f32
from ..reference.train import AdamW, train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def stat_names(model: torch.nn.Module) -> List[str]:
    return [k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))]


class Driver:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch, self.hw = traffic["batch"], (traffic["height"], traffic["width"])
        self.steps = 0

    def setup(self, hook=None) -> None:
        """Build the state and drive its first steps; ``hook(self)`` runs
        between (the check's own tests plant faults there)."""
        from mde_tpu_torch.train.state import TrainState
        from mde_tpu_torch.train.step import make_train_step
        cfg, t = self.config, self.traffic
        model = harness.build_program(cfg, self.device)
        model.load_state_dict(inputs.make_weights(harness.template(model), self.seed,
                                                  self.device))
        self.opt = harness.program_options(cfg)
        self.state = TrainState.create(model, self.opt, cfg["total_steps"])
        self.step = make_train_step(self.opt, cfg["min_depth"], cfg["max_depth"])
        self.images = inputs.make_images(t["pool"], self.batch, *self.hw, self.seed,
                                         self.device)
        self.depths = inputs.make_depths(t["pool"], self.batch, *self.hw, self.seed,
                                         self.device, t["depth_density"], t["sky_rows"],
                                         cfg["max_depth"])
        self.generator = inputs.generator(self.seed, "dropout", self.device)
        if hook is not None:
            hook(self)
        self.first = self.drive_first(t["check_steps"])
        _sync(self.device)

    def drive_first(self, steps: int) -> dict:
        """The first steps through the window's own call; what the check
        compares."""
        losses, grads = [], None
        for _ in range(steps):
            logs = self.call()["logs"]
            losses.append(float(logs["loss"]))
            if grads is None:
                o = self.state.optimizer
                grads = leaf_norms({n: m.float() / (1 - o.b1) for n, m in zip(o.names, o.mu)})
        model = self.state.model
        start = inputs.make_weights(harness.template(model), self.seed, self.device)
        now = model.state_dict()
        names = [n for n, _ in model.named_parameters()] + stat_names(model)
        moved = leaf_norms({n: now[n].float() - start[n] for n in names})
        return {"loss": losses, "grad": grads, "moved": moved}

    def call(self) -> dict:
        i = self.steps % self.traffic["pool"]
        self.state, logs = self.step(self.state, {"image": self.images[i],
                                                  "depth": self.depths[i]}, self.generator)
        self.steps += 1
        return {"logs": logs}

    def window(self, seconds: float) -> dict:
        losses = []
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            losses.append(self.call()["logs"]["loss"])
        _sync(self.device)
        elapsed = time.perf_counter() - start
        failed = int(sum(not bool(torch.isfinite(x)) for x in losses))
        return {"seconds": elapsed, "images": len(losses) * self.batch, "calls": len(losses),
                "failed": failed}

    def end_to_end(self, w: dict) -> Dict[str, float]:
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        return {"train_img_s": w["images"] / w["seconds"], "train_peak_gib": peak / 2 ** 30}

    def free(self) -> None:
        del self.state, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self, numerics: str = "f32", rows: int = None) -> dict:
        """The reference (or the control) over the same first steps: the
        same dictionary as the program's. ``rows`` keeps the first rows of
        each batch (a fault of the check's own tests)."""
        cfg = self.config
        num = Numerics(numerics)
        with torch.device("meta"):
            ref = reference.build(cfg, num, self.hw, checkpoint_blocks=True)
        ref = ref.to_empty(device=self.device)
        start = inputs.make_weights(harness.template(ref), self.seed, self.device)
        ref.load_state_dict(start)
        opt = AdamW(dict(ref.named_parameters()), self.opt, cfg["total_steps"])
        gen = inputs.generator(self.seed, "dropout", self.device)
        losses, grads = [], None
        with strict_f32():
            for i in range(len(self.first["loss"])):
                out = train_step(ref, opt, self.images[i][:rows], self.depths[i][:rows],
                                 self.opt, cfg["min_depth"], cfg["max_depth"], gen)
                losses.append(out["loss"])
                if grads is None:
                    grads = leaf_norms(dict(zip(opt.names, out["grads"])))
        now = ref.state_dict()
        names = opt.names + stat_names(ref)
        moved = leaf_norms({n: now[n].float() - start[n] for n in names})
        del ref, opt, start, now
        return {"loss": losses, "grad": grads, "moved": moved}

    def numbers(self, want: dict, got: dict = None) -> Dict[str, float]:
        return compare(self.first if got is None else got, want)

    def notes(self, want: dict):
        """Where the program's numbers come from, for the log."""
        return [f"worst leaves: {worst_leaves(self.first, want)}"]


def _gaps(got: Dict[str, float], want: Dict[str, float], names) -> Dict[str, float]:
    names = list(names)
    floor = sorted(want[n] for n in names)[len(names) // 2]
    return {n: abs(got[n] - want[n]) / max(want[n], floor, 1e-30) for n in names}


def worst_leaves(got: dict, want: dict) -> Dict[str, str]:
    """Which leaf gives each number of :func:`compare` (for the log)."""
    out = {}
    for key, part, names in _parts(want):
        gaps = _gaps(got[part], want[part], names)
        out[key] = max(gaps, key=gaps.get) if gaps else ""
    return out


def _parts(want: dict):
    grad_floor = sorted(want["grad"].values())[len(want["grad"]) // 2]
    moving = [n for n, g in want["grad"].items() if g >= 1e-3 * grad_floor]
    stats = [n for n in want["moved"] if n not in want["grad"]]
    return [("grad_gap", "grad", list(want["grad"])), ("change_gap", "moved", moving),
            ("bn_gap", "moved", stats)]


def compare(got: dict, want: dict) -> Dict[str, float]:
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))}
    for key, part, names in _parts(want):
        gaps = sorted(_gaps(got[part], want[part], names).values()) or [0.0]
        out[key] = gaps[-1]
        if key == "change_gap":
            out["change_median_gap"] = gaps[len(gaps) // 2]
    return out
