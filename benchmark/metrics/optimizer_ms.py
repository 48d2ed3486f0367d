"""The optimizer's device time a step: the span ``mde.train.optimizer``
(from the gathered gradients through ``grad_norm``, the clip, the AdamW
update and ``param_norm``), between the CUDA events at its ends, over the
card-only stretch's steps, in ms."""

from benchmark.metrics._spans import device_ms_a_call


def read(name, rec):
    return device_ms_a_call(rec, "mde.train.optimizer")
