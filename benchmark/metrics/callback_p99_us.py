"""99th percentile of the callback latency over all callbacks of the window."""

from benchmark.lib.readers import percentile_us


def read(run):
    return percentile_us(run, 99)
