"""The steps of history B3's time-batched MAC ran, over those the dense
kernel walks in the same windows, over the run, in percent: the program's
counters ``stream_mac.steps_run`` and ``stream_mac.steps_dense``
(``neojax_torch.trace.snapshot()["counters"]``). None where the program
keeps no such counter or launched no MAC on the card."""


def read(run):
    try:
        from neojax_torch import trace
    except ImportError:
        return None
    counters = trace.snapshot().get("counters", {})
    steps_run, dense = counters.get("stream_mac.steps_run"), counters.get("stream_mac.steps_dense")
    if steps_run is None or not dense:
        return None
    return 100.0 * steps_run / dense
