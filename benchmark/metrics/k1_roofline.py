"""K1 (the Swin window attention's forward kernel) against its roofline:
over every ``mde::window_attention`` and ``mde::window_attention_qk_v``
call in the profiled stretch, the sum of each call's least time over the
sum of its kernels' device time, in %."""

from benchmark.trace import roofline_share

OPS = ("window_attention", "window_attention_qk_v")


def read(name, rec):
    if rec.trace is None:
        return None
    found = roofline_share(rec.trace, OPS)
    if found is None:
        return None
    rec.note(f"{name}: {found[1]}")
    return found[0]
