"""The recompute's device time a step: the spans ``mde.remat.replay`` (a
checkpointed block's forward run again inside the backward) summed, each
between the CUDA events at its ends, over the card-only stretch's steps,
in ms."""

from benchmark.metrics._spans import device_ms_a_call


def read(name, rec):
    return device_ms_a_call(rec, "mde.remat.replay")
