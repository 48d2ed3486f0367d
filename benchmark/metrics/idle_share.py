"""The card's idle share: 1 less the union of its kernel, copy and set
intervals over the wall time of the stretch that traces the card alone,
in %."""


def read(name, rec):
    if rec.device_trace is None:
        return None
    return 100.0 * rec.device_trace.idle_share()
