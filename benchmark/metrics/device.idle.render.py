"""Idle share of the device over the traced stretch of process calls, busy
time being the union of device intervals, in percent."""

from benchmark.lib.readers import idle_pct


def read(run):
    return idle_pct(run, None)
