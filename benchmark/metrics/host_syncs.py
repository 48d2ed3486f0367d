"""Device-to-host synchronisations a call (a train step): the runtime calls
in the profiled stretch that make the host wait for the card
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, synchronous ``cudaMemcpy``), less the harness's
own, over the stretch's calls."""


def read(name, rec):
    if rec.trace is None:
        return None
    return rec.trace.syncs() / rec.trace.calls
