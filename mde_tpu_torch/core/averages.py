"""Running averages and timing helpers (``mde_tpu/core/averages.py``).

Equivalents of the reference experiment utilities
(``utils/common_utils.py:92-147``): incremental-mean running averages (scalar
and dict form) and a lightweight wall/process timer.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional


class RunningAverage:
    """Incremental mean with the reference's exact update rule
    (``utils/common_utils.py:92-113``): avg += (new - avg) / count."""

    def __init__(self):
        self.avg = 0.0
        self.count = 0

    def append(self, value: float, n: int = 1) -> None:
        value = float(value)
        for _ in range(n):
            self.count += 1
            self.avg += (value - self.avg) / self.count

    def get_value(self) -> float:
        return self.avg

    def reset(self) -> None:
        self.avg = 0.0
        self.count = 0


class RunningAverageDict:
    """Dict of running averages keyed lazily on first update
    (``utils/common_utils.py:116-136``)."""

    def __init__(self):
        self._dict: Optional[Dict[str, RunningAverage]] = None

    def update(self, new_dict: Mapping[str, float]) -> None:
        if self._dict is None:
            self._dict = {key: RunningAverage() for key in new_dict}
        for key, value in new_dict.items():
            if key not in self._dict:
                self._dict[key] = RunningAverage()
            self._dict[key].append(value)

    def get_value(self) -> Dict[str, float]:
        if self._dict is None:
            return {}
        return {key: ra.get_value() for key, ra in self._dict.items()}

    def reset(self) -> None:
        self._dict = None


class Timer:
    """Millisecond timer on the host's clock. The reference used
    ``time.process_time_ns`` (``utils/common_utils.py:139-147``); the card
    runs its work asynchronously, so the default is the wall clock
    (``perf_counter_ns``), which bounds a step's time, with process time as
    an option. It never synchronises the card: a reading counts what the
    host has queued, and a window of many steps what the card has run."""

    def __init__(self, process_time: bool = False):
        self._clock = time.process_time_ns if process_time else time.perf_counter_ns
        self._t0 = self._clock()

    def reset(self) -> None:
        self._t0 = self._clock()

    def elapsed_ms(self) -> float:
        return (self._clock() - self._t0) / 1e6

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *exc):
        self.ms = self.elapsed_ms()
        return False


def time_log() -> str:
    """Timestamp banner (reference ``utils/common_utils.py:60-62``)."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    return f"-------- {stamp} --------"
