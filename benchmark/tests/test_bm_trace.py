"""The trace reduction on a hand-made Chrome trace (times in µs)."""

import pytest

from benchmark.lib.trace import Trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def trace():
    return Trace([
        _x("user_annotation", "live.wait", 0, 100),
        _x("user_annotation", "live.callback", 100, 50),
        _x("user_annotation", "live.call", 100, 30),
        _x("user_annotation", "live.d2h", 130, 20),
        _x("kernel", "k", 110, 10),
        _x("gpu_memcpy", "m", 140, 8),
        _x("gpu_user_annotation", "live.call", 100, 30),  # not device work
        _x("user_annotation", "live.wait", 150, 100),
        _x("user_annotation", "live.callback", 250, 50),
        _x("kernel", "k", 260, 10),
        _x("kernel", "k", 265, 10),
    ])


def test_busy_is_the_union_of_device_intervals(trace):
    a, b = trace.window("live.callback")
    assert (a, b) == pytest.approx((100e-6, 300e-6))
    assert trace.busy_in(a, b) == pytest.approx(33e-6)
    assert trace.busy_in_spans("live.callback") == pytest.approx((33e-6, 100e-6))
    assert trace.kernels == 3


def test_idle_time_goes_to_the_innermost_span_the_host_was_in(trace):
    bd = trace.breakdown(*trace.window("live.callback"))
    gaps = dict(bd["idle_gaps"])
    assert gaps == pytest.approx({"live.wait": 100e-6, "live.call": 20e-6, "live.d2h": 12e-6,
                                  "live.callback": 35e-6})
    assert dict(bd["device_ops"]) == pytest.approx({"k": 30e-6, "m": 8e-6})
