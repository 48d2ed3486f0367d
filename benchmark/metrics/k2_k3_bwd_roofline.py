"""K2's and K3's backward kernels against their rooflines, together: over
every ``mde::ordered_attention_bwd``, ``mde::depthwise_conv2d_dxdw`` and
``mde::depthwise_conv2d_dw`` call in the profiled stretch, the sum of each
call's least time over the device time of the kernels the calls launch,
in %: each call's pass (its work module's ``KERNEL``, one a call) and,
for K3, the reduction of the pass's partial sums (``ALSO``, one a call).
Nothing where the program's backward entries are not operators, or the
calls and the launches do not pair up."""

from benchmark import harness

OPS = ("ordered_attention_bwd", "depthwise_conv2d_dxdw", "depthwise_conv2d_dw")


def _pattern(patterns):
    return "|".join(f"(?:{p})" for p in sorted(patterns))


def share(trace, ops):
    """(the share in %, which bound rules on how many calls), or None."""
    peaks = harness.load_json("work", "peaks")
    least, calls, by_bytes, with_also = 0.0, 0, 0, 0
    passes, also = set(), set()
    for op in ops:
        work = harness.load_module("work", op)
        passes.add(work.KERNEL)
        extra = getattr(work, "ALSO", None)
        if extra:
            also.add(extra)
        for dims, types in trace.op_calls(f"mde::{op}"):
            nbytes, flops = work.cost(dims, types)
            t_bytes = nbytes / peaks["hbm_bytes_per_s"]
            t_ops = flops / peaks["bf16_flops_per_s"]
            least += max(t_bytes, t_ops)
            by_bytes += t_bytes >= t_ops
            calls += 1
            with_also += bool(extra)
    seconds, launches = trace.kernel_time(_pattern(passes))
    extra_s, extra_launches = trace.kernel_time(_pattern(also)) if also else (0.0, 0)
    if calls == 0 or calls != launches or with_also != extra_launches or seconds <= 0:
        return None
    return 100.0 * least / (seconds + extra_s), f"bytes bound on {by_bytes} of {calls} calls"


def read(name, rec):
    if rec.trace is None:
        return None
    found = share(rec.trace, OPS)
    if found is None:
        return None
    rec.note(f"{name}: {found[1]}")
    return found[0]
