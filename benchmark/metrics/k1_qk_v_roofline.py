"""K1's q|k + separate-v entry alone against its roofline: over every
``mde::window_attention_qk_v`` call in the profiled stretch, the sum of
each call's least time over the device time of the kernel it launched, in
%.

Both K1 entries (``mde::window_attention`` and
``mde::window_attention_qk_v``) launch kernels of one name, so a call's
kernel is found by order: the calls of both entries in the order the host
made them pair one to one with the K1 kernels in the order the card ran
them (one stream). Nothing where no q|k + v call ran or the calls and the
launches do not pair up."""

from __future__ import annotations

import re

from benchmark import harness

OPS = ("window_attention", "window_attention_qk_v")
OWN = "window_attention_qk_v"


def outermost(trace, op: str):
    """(start, input dims, input types) of each outermost call of ``op``."""
    calls = sorted((ts, dur, args) for ts, dur, name, cat, args in trace.host
                   if cat == "cpu_op" and name == op)
    out, end = [], -1.0
    for ts, dur, args in calls:
        if ts < end:
            continue
        end = ts + dur
        out.append((ts, args.get("Input Dims", []), args.get("Input type", [])))
    return out


def share(trace):
    """(the share in %, which bound rules on how many calls), or None."""
    peaks = harness.load_json("work", "peaks")
    work = harness.load_module("work", OWN)
    calls = sorted((ts, op, dims, types) for op in OPS
                   for ts, dims, types in outermost(trace, f"mde::{op}"))
    patterns = {harness.load_module("work", op).KERNEL for op in OPS}
    rx = re.compile("|".join(f"(?:{p})" for p in sorted(patterns)))
    kernels = [dur for _, dur, name in trace.kernels if rx.search(name)]
    if len(kernels) != len(calls):
        return None
    least, seconds, by_bytes, n = 0.0, 0.0, 0, 0
    for (_, op, dims, types), dur in zip(calls, kernels):
        if op != OWN:
            continue
        nbytes, flops = work.cost(dims, types)
        t_bytes = nbytes / peaks["hbm_bytes_per_s"]
        t_ops = flops / peaks["bf16_flops_per_s"]
        least += max(t_bytes, t_ops)
        by_bytes += t_bytes >= t_ops
        seconds += dur * 1e-6
        n += 1
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * least / seconds, f"bytes bound on {by_bytes} of {n} calls"


def read(name, rec):
    if rec.trace is None:
        return None
    found = share(rec.trace)
    if found is None:
        return None
    rec.note(f"{name}: {found[1]}")
    return found[0]
