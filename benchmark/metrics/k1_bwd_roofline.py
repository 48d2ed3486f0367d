"""K1's backward kernel against its roofline: as ``k1_roofline`` over every
``mde::window_attention_bwd`` and ``mde::window_attention_qk_v_bwd`` call
in the profiled stretch and the backward kernel's launches, in %. Nothing
where the program's backward entries are not operators."""

from benchmark.trace import roofline_share

OPS = ("window_attention_bwd", "window_attention_qk_v_bwd")


def read(name, rec):
    if rec.trace is None:
        return None
    found = roofline_share(rec.trace, OPS)
    if found is None:
        return None
    rec.note(f"{name}: {found[1]}")
    return found[0]
