"""Tracing and timing helpers (``mde_tpu/utils/profiling.py``) on
``torch.profiler`` and the CUDA caching allocator.

* :func:`trace`: a context manager around ``torch.profiler`` recording the
  host's ops and the card's kernels, written as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto).
* :class:`StepTimer`: a wall-clock EMA of step latency that synchronises
  the card on demand.
* :func:`device_memory_stats`: the caching allocator's counters of each
  visible card.

One departure from JAX: JAX's ``trace`` swallows a profiler that fails to
start or stop (``:30-41``); this one raises, so that a run never reports a
trace it did not take.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


def profiler(host: bool = True) -> "torch.profiler.profile":
    """An unstarted ``torch.profiler.profile`` recording the card's
    kernels and copies (where CUDA is available) and, with ``host``, the
    host's ops. :func:`trace` records both; a caller that reads only the
    card's device times leaves the host out, whose ops take seconds to
    sum up after a large call."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not activities:
        raise RuntimeError("nothing to profile: no CUDA device and the host left out")
    return profile(activities=activities)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """``with trace("/tmp/trace") as prof: run_steps()`` records the host's
    ops and the card's kernels and writes ``<log_dir>/trace_<pid>.json``, a
    Chrome trace; ``prof.key_averages()`` sums them by name. A profiler
    that fails raises."""
    os.makedirs(log_dir, exist_ok=True)
    prof = profiler(host=True)
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Wall-clock EMA of step latency. ``stop(sync_on=t)`` first waits for
    the card that holds the tensor ``t`` (or each tensor of a list, tuple
    or dict of them), so that asynchronous launches do not hide device
    time."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.ema_ms: Optional[float] = None
        self._t0 = time.perf_counter()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        for device in _cuda_devices(sync_on):
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - self._t0) * 1000.0
        self.ema_ms = ms if self.ema_ms is None else (
            self.momentum * self.ema_ms + (1 - self.momentum) * ms)
        return ms


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_cuda_devices, tree)) if tree else set()
    return set()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{card: {counter: value}} of every visible card, from the caching
    allocator (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``allocated_bytes.all.peak``, ...); empty without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                          if isinstance(v, (int, float))}
            for i in range(torch.cuda.device_count())}
