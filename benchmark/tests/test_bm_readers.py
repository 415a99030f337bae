"""Every metric reader in ``benchmark/metrics/``, on hand-made runs: the
render readers and the live ones a later cell can list."""

import types

import pytest

from benchmark.lib import spec
from benchmark.lib.trace import Trace
from benchmark.lib.traffic import Window


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _run(loop, trace, traced_blocks, call_blocks, **window):
    win = Window()
    win.__dict__.update(window)
    win.traces = [trace] if trace else []
    win.traced_blocks = traced_blocks
    return types.SimpleNamespace(traffic={"loop": loop, "call_blocks": call_blocks}, window=win, setup_s=7.5,
                                 least_bytes_per_call=3.35e6, hbm_bytes_per_s=3.35e12,
                                 trace=trace)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_render_readers():
    # two calls of 4 blocks, each span 10 µs of host, device busy 0-30 and 35-40 µs
    t = Trace([_x("user_annotation", "render.process", 0, 10), _x("user_annotation", "render.process", 10, 10),
               _x("kernel", "a", 0, 30), _x("kernel", "b", 35, 5)])
    run = _run("closed", t, 8, 4, samples=64e6, seconds=2.0, enqueue_s=[4e-3, 6e-3], enqueue_blocks=8)
    assert read("render_msps", run) == pytest.approx(32.0)
    assert read("setup_s", run) == 7.5
    assert read("api.enqueue_us_per_block.render", run) == pytest.approx(1250.0)
    assert read("engine.launches_per_block.render", run) == pytest.approx(0.25)
    assert read("device.idle.render", run) == pytest.approx(12.5)  # 5 of 40 µs idle
    # least 1 µs a call (3.35 MB at 3.35 TB/s), two calls, 35 µs busy
    assert read("kernels.roofline.render", run) == pytest.approx(100 * 2e-6 / 35e-6)
    assert read("callback_p50_us", run) is None


def test_live_readers():
    t = Trace([_x("user_annotation", "live.callback", 0, 100), _x("user_annotation", "live.callback", 200, 100),
               _x("kernel", "a", 10, 20), _x("kernel", "b", 210, 30), _x("gpu_memcpy", "m", 250, 10)])
    lat = [1e-3 * (i + 1) for i in range(100)]
    run = _run("open", t, 2, 1, latencies=lat)
    assert read("callback_p50_us", run) == pytest.approx(50.5e3)
    assert read("callback_p99_us", run) == pytest.approx(99.01e3)
    assert read("engine.launches_per_block.live", run) == pytest.approx(1.0)
    assert read("device.idle_in_callback.live", run) == pytest.approx(70.0)  # 60 of 200 µs busy
    assert read("kernels.roofline.live", run) == pytest.approx(100 * 2e-6 / 60e-6)
    assert read("render_msps", run) is None


def test_untraced_runs_read_nothing():
    run = _run("closed", None, 0, 4, samples=1.0, seconds=1.0)
    for name in ("engine.launches_per_block.render", "kernels.roofline.render", "device.idle.render",
                 "api.enqueue_us_per_block.render", "device.idle_in_callback.live"):
        assert read(name, run) is None
