"""Idle share of the device inside the traced callbacks only, in percent."""

from benchmark.lib.readers import idle_pct


def read(run):
    return idle_pct(run, "live.callback")
