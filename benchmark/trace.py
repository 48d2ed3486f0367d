"""The profiled stretch of a traced run and its reduction.

A stretch is a bounded number of the window's own calls after the
window, under ``torch.profiler``. A traced run makes two: the first
records the card's kernels and copies alone, which costs the host little,
and gives the busy and idle time; the second also records the host's ops
with their shapes and the CUDA runtime's calls, which slows the host two
to three times, and gives what needs the host: the ops' shapes for the
rooflines, the synchronisations, and what the host ran across each idle
gap. The profile goes through a Chrome trace in ``TMPDIR``, deleted once
read.

- busy: the union of the card's kernel, copy and set intervals inside the
  stretch; idle share = 1 - busy / wall;
- a kernel op's roofline share: over its calls in the stretch, the sum of
  each call's least time (its bytes over the peak bandwidth or its
  operations over the peak rate, whichever is longer, from the work
  module named after the op and the call's recorded shapes) over the sum
  of the device time of the op's kernels;
- synchronisations: the runtime calls that make the host wait for the
  card, less the harness's own;
- breakdown: the kernels that took most time, and the idle gaps by the
  innermost host op or runtime call running across each.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import harness

STRETCH = "benchmark.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")


def profile(call: Callable[[], object], n: int, host: bool) -> "Trace":
    """Run ``call`` ``n`` times under the profiler, recording the card's
    activity and, with ``host``, the host's ops with their shapes and the
    runtime's calls; the stretch ends in one synchronisation of the
    harness's own."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with torch_profile(activities=activities, record_shapes=host) as prof:
        with record_function(STRETCH):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, n, wall, own_syncs=1)


class Trace:
    def __init__(self, events: List[dict], calls: int, wall_s: float, own_syncs: int):
        self.calls, self.host_wall_s, self.own_syncs = calls, wall_s, own_syncs
        spans = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.span_s = None
        if spans:
            self.t0 = float(spans[0]["ts"])
            self.t1 = self.t0 + float(spans[0]["dur"])
            self.span_s = (self.t1 - self.t0) * 1e-6
        else:  # the card's activity alone: all of it, over the host's clock
            device = [e for e in timed if e.get("cat") in DEVICE_CATS]
            if not device:
                raise RuntimeError("the profile recorded no activity on the card")
            self.t0 = min(float(e["ts"]) for e in device)
            self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in device)
        inside = [e for e in timed if self.t0 <= float(e["ts"]) <= self.t1]
        device = sorted((float(e["ts"]), float(e["dur"]), e["name"], e["cat"]) for e in inside
                        if e.get("cat") in DEVICE_CATS)
        self.device = [(ts, dur, name) for ts, dur, name, _ in device]
        self.kernels = [(ts, dur, name) for ts, dur, name, cat in device if cat == "kernel"]
        self.host = [(float(e["ts"]), float(e["dur"]), e["name"], e.get("cat"),
                      e.get("args", {})) for e in inside
                     if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]

    @property
    def window_s(self) -> float:
        """The stretch's wall time: its annotation's span, else the host's
        clock around it."""
        return self.span_s if self.span_s is not None else self.host_wall_s

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for ts, dur, _ in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def syncs(self) -> int:
        """Runtime calls that wait for the card, less the harness's own."""
        count = sum(1 for _, _, name, cat, _ in self.host
                    if cat == "cuda_runtime" and name in SYNC_CALLS)
        return count - self.own_syncs

    def sync_sources(self, top: int = 4) -> List[Tuple[str, int]]:
        """The host ops that the waiting runtime calls ran under, by count."""
        found: Dict[str, int] = defaultdict(int)
        for ts, dur, name, cat, _ in self.host:
            if cat == "cuda_runtime" and name in SYNC_CALLS:
                found[f"{name} in {self.host_at(ts + 0.5 * dur, cat='cpu_op')}"] += 1
        return sorted(found.items(), key=lambda kv: -kv[1])[:top]

    def op_calls(self, name: str) -> List[Tuple[list, list]]:
        """(input dims, input types) of each outermost call of the host op
        ``name``."""
        calls = sorted((ts, dur, args) for ts, dur, n, cat, args in self.host
                       if cat == "cpu_op" and n == name)
        out, end = [], -1.0
        for ts, dur, args in calls:
            if ts < end:  # nested inside a call of the same op
                continue
            end = ts + dur
            out.append((args.get("Input Dims", []), args.get("Input type", [])))
        return out

    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [dur for _, dur, name in self.kernels if rx.search(name)]
        return sum(hits) * 1e-6, len(hits)

    def breakdown(self, top: int = 10, named_gaps: int = 200) -> Dict[str, List[list]]:
        """The ``top`` kernels and copies by device time, and the idle time
        of the ``named_gaps`` longest gaps by the host op running across
        each, ``top`` of them (seconds)."""
        by_kernel: Dict[str, float] = defaultdict(float)
        for _, dur, name in self.device:
            by_kernel[name] += dur * 1e-6
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > prev:
                gaps.append((a - prev, 0.5 * (prev + a)))
            prev = max(prev, b)
        by_host: Dict[str, float] = defaultdict(float)
        for length, mid in sorted(gaps, reverse=True)[:named_gaps]:
            by_host[self.host_at(mid)] += length * 1e-6

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(by_kernel), "idle_gaps": ranked(by_host)}

    def host_at(self, t: float, cat: Optional[str] = None) -> str:
        """The innermost host op or runtime call (of ``cat`` only, where
        given) running at ``t``."""
        best: Optional[Tuple[float, str]] = None
        for ts, dur, name, c, _ in self.host:
            if (cat is None or c == cat) and ts <= t <= ts + dur and (
                    best is None or dur < best[0]):
                best = (dur, name)
        return best[1] if best else "harness (no host op)"


def roofline_share(trace: Trace, ops: Sequence[str]) -> Optional[Tuple[float, str]]:
    """(the share in %, which bound rules on how many calls) over the calls
    of the ``mde::<op>`` host ops in ``ops`` and the launches of their
    kernels (each kernel counted once, though two ops share it); None where
    none ran or the calls and the launches do not pair up."""
    peaks = harness.load_json("work", "peaks")
    least, calls, by_bytes, patterns = 0.0, 0, 0, []
    for op in ops:
        work = harness.load_module("work", op)
        patterns.append(work.KERNEL)
        for dims, types in trace.op_calls(f"mde::{op}"):
            nbytes, flops = work.cost(dims, types)
            t_bytes = nbytes / peaks["hbm_bytes_per_s"]
            t_ops = flops / peaks["bf16_flops_per_s"]
            least += max(t_bytes, t_ops)
            by_bytes += t_bytes >= t_ops
            calls += 1
    seconds, launches = trace.kernel_time("|".join(f"(?:{p})" for p in set(patterns)))
    if calls == 0 or calls != launches or seconds <= 0:
        return None
    return 100.0 * least / seconds, f"bytes bound on {by_bytes} of {calls} calls"
