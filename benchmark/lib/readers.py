"""Arithmetic the metric readers share. Each returns None where its run
has nothing to read (no trace, no device operation, a card not in the
table of peaks), and the harness then leaves the metric out."""

from __future__ import annotations

import numpy as np

from benchmark.lib.traffic import STRETCH_SPAN

__all__ = ["percentile_us", "launches_per_block", "roofline_pct", "idle_pct"]


def percentile_us(run, q: float):
    lat = run.window.latencies
    return float(np.percentile(lat, q)) * 1e6 if lat else None


def launches_per_block(run):
    t = run.trace
    if t is None or not t.kernels or not run.window.traced_blocks:
        return None
    return t.kernels / run.window.traced_blocks


def _busy(run, span: str | None):
    """(device busy seconds, host seconds) of the traced stretch, or inside
    the ``span`` spans only."""
    t = run.trace
    if t is None or not t.device_ops:
        return None
    if span is None:
        a, b = t.window(STRETCH_SPAN[run.traffic["loop"]])
        return t.busy_in(a, b), b - a
    return t.busy_in_spans(span)


def roofline_pct(run, span: str | None):
    """The least time of the traced calls over their device busy time."""
    busy = _busy(run, span)
    if busy is None or not busy[0] or not run.hbm_bytes_per_s:
        return None
    calls = run.window.traced_blocks / run.traffic["call_blocks"]
    return 100.0 * calls * run.least_bytes_per_call / run.hbm_bytes_per_s / busy[0]


def idle_pct(run, span: str | None):
    busy = _busy(run, span)
    if busy is None or not busy[1]:
        return None
    return 100.0 * (1.0 - busy[0] / busy[1])
