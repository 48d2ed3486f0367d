"""K2, K3 and K4 (the ordered attention, the depthwise convolution and the
fused GLU feed-forward, forward kernels) against their rooflines, together:
as ``k1_roofline`` over every ``mde::ordered_attention``,
``mde::depthwise_conv2d`` and ``mde::glu_ff`` call in the profiled
stretch, in %."""

from benchmark.trace import roofline_share

OPS = ("ordered_attention", "depthwise_conv2d", "glu_ff")


def read(name, rec):
    if rec.trace is None:
        return None
    found = roofline_share(rec.trace, OPS)
    if found is None:
        return None
    rec.note(f"{name}: {found[1]}")
    return found[0]
