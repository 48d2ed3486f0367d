"""NeW CRFs' CRF stages' device time a serving call: the four spans
``mde.newcrfs.crf`` (a stage each, its pixel shuffle included) summed,
each between the CUDA events at its ends, over the card-only stretch's
calls, in ms. Nothing where the program records no such span."""

from benchmark.metrics._spans import device_ms_a_call


def read(name, rec):
    return device_ms_a_call(rec, "mde.newcrfs.crf")
