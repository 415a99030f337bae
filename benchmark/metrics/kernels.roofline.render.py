"""Least time of the traced process calls (benchmark/lib/work.py, bytes at
the card's HBM rate) over their device busy time, in percent."""

from benchmark.lib.readers import roofline_pct


def read(run):
    return roofline_pct(run, None)
