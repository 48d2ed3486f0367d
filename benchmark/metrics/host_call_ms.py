"""Host time of a serving call: from a batch's submission until
``Predictor.predict`` returns, before the harness waits for the depth maps
(the benchmark's host clock); the mean over the window's calls."""


def read(name, rec):
    host = rec.window.get("host_call_ms")
    return sum(host) / len(host) if host else None
