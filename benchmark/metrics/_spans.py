"""The program's own spans (``mde_tpu_torch.utils.profiling.spans``) in a
traced run, shared by the readers of the metrics that read them.

A span is recorded only while a profile records, and the traced run makes
its two stretches in a fixed order: of the top-level calls the program
recorded, the last ``device_trace.calls + trace.calls`` are the two
stretches' calls, the card-only stretch's first. The spans are read once
a run and kept on the record, and their table (a line a stretch and span
name: count a call, host ms, host self ms and device ms a call, counters
a call) goes to the log. A program without spans gives nothing."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

KEY = "program_spans"


def stretches(rec) -> Optional[Dict[str, List[List[dict]]]]:
    """{"card": [each card-only call's spans], "host": [the host stretch's]},
    or None."""
    if KEY not in rec.__dict__:
        rec.__dict__[KEY] = _read(rec)
    return rec.__dict__[KEY]


def _read(rec):
    if rec.device_trace is None or rec.trace is None:
        return None
    from mde_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None
    dropped = profiling.dropped()
    records = profiling.spans()
    by_call = defaultdict(list)
    for r in records:
        by_call[r["call"]].append(r)
    n_card, n_host = rec.device_trace.calls, rec.trace.calls
    calls = sorted(by_call)[-(n_card + n_host):]
    if len(calls) < n_card + n_host:
        return None
    found = {"card": [by_call[c] for c in calls[:n_card]],
             "host": [by_call[c] for c in calls[n_card:]]}
    if dropped:
        rec.note(f"spans: {dropped} dropped (the program's buffer was full)")
    for stretch, group in found.items():
        for line in table(group):
            rec.note(f"spans, {stretch} stretch: {line}")
    return found


def table(calls: List[List[dict]]) -> List[str]:
    """A line a span name over ``calls``: its count, host ms, self ms,
    device ms and counters, each a call."""
    n = len(calls)
    rows: Dict[str, dict] = {}
    for call in calls:
        for r in call:
            row = rows.setdefault(r["name"], {"count": 0, "host": 0.0, "self": 0.0,
                                              "device": 0.0, "counters": defaultdict(int)})
            row["count"] += 1
            row["host"] += r["host_ms"]
            row["self"] += r["self_ms"]
            row["device"] += r["device_ms"] or 0.0
            for k, v in r["counters"].items():
                row["counters"][k] += v
    return [f"{name} x{row['count'] / n:g}: host {row['host'] / n:.3f} ms, self "
            f"{row['self'] / n:.3f}, device {row['device'] / n:.3f}"
            + "".join(f", {k} {v / n:g}" for k, v in sorted(row["counters"].items()))
            for name, row in rows.items()]


def device_ms_a_call(rec, name: str) -> Optional[float]:
    """The device ms of the spans ``name`` summed over the card-only
    stretch, over its calls; None where no such span was recorded."""
    found = stretches(rec)
    if found is None:
        return None
    times = [r["device_ms"] for call in found["card"] for r in call if r["name"] == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(found["card"])
