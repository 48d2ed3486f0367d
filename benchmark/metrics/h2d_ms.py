"""A serving call's copy in: the span ``mde.serve.h2d`` (the batch made on
the card from host memory) between the CUDA events at its ends, over the
card-only stretch's calls, in ms."""

from benchmark.metrics._spans import device_ms_a_call


def read(name, rec):
    return device_ms_a_call(rec, "mde.serve.h2d")
