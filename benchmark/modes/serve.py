"""Serving: ``mde_tpu_torch.serve.Predictor.predict`` in a closed loop of
one client. A request is a batch of frames from a pool held in pinned host
memory; it is timed from its submission (frames on the host) to its depth
maps in a pinned host buffer, and the next is sent when it is done.

For the check, the depth maps of one call of each pool batch (which
occurrence is drawn from the seed) land in buffers of their own; after
the window the reference computes the same frames in float32 and the
numbers below compare them, over all those frames:

- ``depth_rms_rel``: the RMS of the gap over the RMS of the reference;
- ``frame_gap``: the worst frame's RMS gap over that frame's spread (the
  standard deviation of its reference map).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import harness, inputs, reference
from ..reference.layers import Numerics, strict_f32


class Driver:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch, self.hw = traffic["batch"], (traffic["height"], traffic["width"])
        self.pool_size = traffic["pool"]
        # which occurrence of each pool batch the check keeps
        rng = np.random.default_rng(inputs.stream_seed(seed, "sample"))
        self.keep_at = [int(k) for k in rng.integers(0, traffic["keep_within"],
                                                     self.pool_size)]
        self.seen = [0] * self.pool_size
        self.calls = 0

    def setup(self, hook=None) -> None:
        """Build the predictor and warm it up; ``hook(self)`` runs between
        (the check's own tests plant faults there)."""
        from mde_tpu_torch.serve import Predictor
        model = harness.build_program(self.config, self.device)
        model.load_state_dict(inputs.make_weights(harness.template(model), self.seed,
                                                  self.device))
        self.predictor = Predictor(model)
        pin = self.device.type == "cuda"
        frames = inputs.make_images(self.pool_size, self.batch, *self.hw, self.seed, self.device)
        self.pool = [torch.empty(frames.shape[1:], pin_memory=pin).copy_(f) for f in frames]
        del frames
        shape = (self.batch, *self.hw, 1)
        self.out = torch.empty(shape, pin_memory=pin)
        self.kept = [torch.empty(shape, pin_memory=pin) for _ in range(self.pool_size)]
        if hook is not None:
            hook(self)
        for i in range(self.traffic["warmup_calls"]):
            self.out.copy_(self.predictor.predict(self.pool[i % self.pool_size]))
        self.seen = [0] * self.pool_size
        self.filled = [False] * self.pool_size

    def call(self) -> Dict[str, float]:
        """One request; returns its host-side call time and latency (s)."""
        slot = self.calls % self.pool_size
        keep = self.seen[slot] == self.keep_at[slot]
        dest = self.kept[slot] if keep else self.out
        t0 = time.perf_counter()
        depth = self.predictor.predict(self.pool[slot])
        t1 = time.perf_counter()
        dest.copy_(depth)
        t2 = time.perf_counter()
        self.seen[slot] += 1
        self.calls += 1
        self.filled[slot] |= keep
        ok = bool(torch.isfinite(dest).all()) if keep else True
        return {"host_s": t1 - t0, "latency_s": t2 - t0, "ok": ok}

    def window(self, seconds: float) -> dict:
        host, lat, failed, frames = [], [], 0, 0
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            r = self.call()
            if time.perf_counter() > deadline:
                break
            host.append(r["host_s"])
            lat.append(r["latency_s"])
            failed += not r["ok"]
            frames += self.batch
        return {"seconds": seconds, "images": frames, "calls": len(lat), "failed": failed,
                "host_call_ms": [1e3 * h for h in host], "latency_ms": [1e3 * t for t in lat]}

    def end_to_end(self, w: dict) -> Dict[str, float]:
        lat = w["latency_ms"]
        return {"serve_img_s": w["images"] / w["seconds"],
                "serve_p95_ms": float(np.percentile(lat, 95)) if lat else float("nan")}

    def free(self) -> None:
        """Drop the program's model before the reference runs."""
        del self.predictor
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self, numerics: str = "f32") -> List[torch.Tensor]:
        """The kept frames' depth maps from the reference (or the control)."""
        num = Numerics(numerics)
        with torch.device("meta"):
            ref = reference.build(self.config, num, self.hw, checkpoint_blocks=False)
        ref = ref.to_empty(device=self.device)
        ref.load_state_dict(inputs.make_weights(harness.template(ref), self.seed, self.device))
        ref.eval()
        from ..reference.layers import resize
        outs = []
        with torch.no_grad(), strict_f32():
            for frames in self.pool:
                x = frames.to(self.device)
                parts = []
                for rows in torch.split(x, self.traffic["check_rows"]):
                    depth = ref(rows)[0]
                    parts.append(resize(depth.float(), self.hw).clamp_min(0.0).cpu())
                outs.append(torch.cat(parts))
        del ref
        return outs

    def numbers(self, want: List[torch.Tensor], got: List[torch.Tensor] = None
                ) -> Dict[str, float]:
        if got is None:
            if not all(self.filled):  # a kept call never came: no answer to judge
                return {k: float("inf") for k in compare(want, want)}
            got = self.kept
        return compare(got, want)

    def notes(self, want: List[torch.Tensor]):
        return []


def compare(got: List[torch.Tensor], want: List[torch.Tensor]) -> Dict[str, float]:
    g = torch.cat([t.reshape(t.shape[0], -1) for t in got]).double()
    r = torch.cat([t.reshape(t.shape[0], -1) for t in want]).double()
    gap = g - r
    frame = gap.pow(2).mean(dim=1).sqrt() / r.std(dim=1).clamp_min(1e-12)
    return {"depth_rms_rel": float(gap.pow(2).mean().sqrt() / r.pow(2).mean().sqrt()),
            "frame_gap": float(frame.max())}
