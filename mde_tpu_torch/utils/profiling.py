"""Tracing and timing helpers (``mde_tpu/utils/profiling.py``) on
``torch.profiler`` and the CUDA caching allocator.

* :func:`trace`: a context manager around ``torch.profiler`` recording the
  host's ops and the card's kernels, written as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto).
* :func:`span` and :func:`count`: the program's own spans at its layer
  boundaries (``mde.serve.*``, ``mde.train.*``, ``mde.remat.replay``),
  recorded only while a ``torch.profiler`` profile records, and read back
  by :func:`spans`.
* :func:`device_memory_stats`: the caching allocator's counters of each
  visible card.

One departure from JAX: JAX's ``trace`` swallows a profiler that fails to
start or stop (``:30-41``); this one raises, so that a run never reports a
trace it did not take.

Reading the spans. Under :func:`trace` (or any ``torch.profiler``
profile) each span is a ``record_function`` range, a ``user_annotation``
event of the Chrome trace: open the trace in Perfetto and every kernel and
idle gap of the card lies under the span that was open on the host. After
a profiled stretch, synchronise and call :func:`spans` for the records
themselves: each span's host time, its self time (less its children's),
its device time between CUDA events recorded on the current stream at its
entry and exit, its counters and the call it belongs to. With no profile
recording a span costs one check and records nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

# whether a torch.profiler profile is recording (the profiler's own state)
_recording = torch._C._autograd._profiler_enabled
# finished spans kept until :func:`spans` reads them; past this many, a span
# is counted in ``_dropped`` and not kept
CAPACITY = 1 << 16

_lock = threading.Lock()
# the open spans, innermost last. One stack for the process, as
# ``parallel.mesh.gspmd_scope`` is one flag: a CUDA backward, and the
# recompute's replays in it, run in autograd's threads while the thread
# that opened the step's spans waits for them.
_open: List["_Span"] = []
_done: List["_Span"] = []
_dropped = 0
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)  # a top-level span's, shared by the spans inside it


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


class _Off:
    """The span of a process that no profile records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):  # named: ``*exc`` would build a tuple
        return False


_OFF = _Off()


def _device_event() -> Optional[torch.cuda.Event]:
    if not torch.cuda.is_initialized():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Span:
    __slots__ = ("name", "id", "parent", "call", "counters", "host", "device", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        with _lock:
            parent = _open[-1] if _open else None
            self.id = next(_span_ids)
            self.parent = None if parent is None else parent.id
            self.call = next(_call_ids) if parent is None else parent.call
            self.counters: Dict[str, int] = {}
            _open.append(self)
        self.device = [_device_event(), None]
        self.host = [time.time_ns(), None]
        return None

    def __exit__(self, *exc):
        global _dropped
        self.host[1] = time.time_ns()
        self.device[1] = _device_event()
        self._range.__exit__(*exc)
        with _lock:
            _open.remove(self)
            if len(_done) < CAPACITY:
                _done.append(self)
            else:
                _dropped += 1
        return False


def span(name: str):
    """``with span("mde.train.optimizer"): ...`` records the block as a span
    of the program while a ``torch.profiler`` profile records: a
    ``record_function`` range of the profile, and a record that
    :func:`spans` returns, whose parent is the span open around it (in
    any thread) and whose call is its top-level span's. Otherwise it
    returns a shared null context at the cost of one check: no range, no
    CUDA event, no allocation."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span; nothing
    where no span is open (as where no profile records)."""
    if _open:
        with _lock:
            if _open:
                counters = _open[-1].counters
                counters[name] = counters.get(name, 0) + n


def dropped() -> int:
    """Spans finished since the last :func:`spans` that found the buffer
    full (``CAPACITY``) and were not kept."""
    return _dropped


def spans() -> List[dict]:
    """The finished spans in the order they ended, and clear them (and the
    drop count). Each is a dict: ``name``; ``id``; ``parent``, the id of
    the span it ran in (None at the top level); ``call``, the identifier
    its top-level span and every span inside it share (one ``predict``
    call, one train step); ``host_start_ns`` and ``host_end_ns`` on
    ``time.time_ns()``; ``host_ms``; ``self_ms``, less the host time of
    its children; ``device_ms`` between its CUDA events (None without
    CUDA); ``counters``. Waits for the card until the last event."""
    global _dropped
    with _lock:
        done = list(_done)
        _done.clear()
        _dropped = 0
    if any(s.device[1] is not None for s in done):
        torch.cuda.synchronize()
    children: Dict[int, int] = {}
    for s in done:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.host[1] - s.host[0]
    out = []
    for s in done:
        start, end = s.device
        host_ns = s.host[1] - s.host[0]
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "call": s.call,
                    "host_start_ns": s.host[0], "host_end_ns": s.host[1],
                    "host_ms": host_ns * 1e-6,
                    "self_ms": (host_ns - children.get(s.id, 0)) * 1e-6,
                    "device_ms": (None if start is None or end is None
                                  else start.elapsed_time(end)),
                    "counters": dict(s.counters)})
    return out


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{card: {counter: value}} of every visible card, from the caching
    allocator (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``allocated_bytes.all.peak``, ...); empty without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                          if isinstance(v, (int, float))}
            for i in range(torch.cuda.device_count())}
