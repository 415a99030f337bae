"""Least time of the traced callbacks (benchmark/lib/work.py, bytes at the
card's HBM rate) over the device busy time inside them, in percent."""

from benchmark.lib.readers import roofline_pct


def read(run):
    return roofline_pct(run, "live.callback")
