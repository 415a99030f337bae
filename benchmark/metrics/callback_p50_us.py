"""Median callback latency, from each block's due time to its output in host
memory, over all callbacks of the window."""

from benchmark.lib.readers import percentile_us


def read(run):
    return percentile_us(run, 50)
