"""The readers of the program's own spans (``benchmark/lib/program_spans.py``)
on hand-made runs, as ``test_bm_readers.py`` does for the others, and on
runs of the render mixes at the small sizes. A program that opens no such
span, and an untraced run, read nothing."""

import sys
import types

import pytest

import neojax_torch
from benchmark.lib.trace import Trace
from benchmark.lib.traffic import Window
from benchmark.tests import tiny
from benchmark.tests.test_bm_readers import _run, _x, read

SPAN_READERS = ("engine.glue_host_us_per_block.render", "kernels.launch_host_us_per_block.render",
                "engine.idle_in_glue.render", "kernels.idle_in_launch.render")
RENDER_MIXES = [("ambi64_10s_split", "render"), ("ambi64_room10s_perc60_bf16", "render")]


def _u(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


@pytest.fixture
def traced_run():
    # two calls of 4 blocks; device busy 0-12, 20-40, 50-96, 100-104, 108-200 µs
    t = Trace([
        _u("render.process", 0, 100), _u("conv.process", 5, 90), _u("conv.dcfix", 10, 20),
        _u("kernels.fused_stream", 35, 55),
        _u("render.process", 100, 100), _u("conv.process", 102, 88), _u("conv.dcfix", 105, 10),
        _u("kernels.fused_stream", 120, 65),
        _x("kernel", "a", 0, 12), _x("kernel", "b", 20, 20), _x("kernel", "c", 50, 46),
        _x("kernel", "d", 100, 4), _x("kernel", "e", 108, 92),
    ])
    return _run("closed", t, 8, 4)


def test_host_time_a_block_is_the_least_over_the_calls(traced_run):
    # outside B3's wrapper: 90 - 55 = 35 and 88 - 65 = 23 µs; inside: 55 and 65 µs
    assert read("engine.glue_host_us_per_block.render", traced_run) == pytest.approx(23 / 4)
    assert read("kernels.launch_host_us_per_block.render", traced_run) == pytest.approx(55 / 4)


def test_the_call_span_is_an_argument():
    """A reader of another engine names its own call span; the default
    (``conv.process``) finds none of them and reads nothing."""
    from benchmark.lib.program_spans import least_us_per_block

    t = Trace([_u("render.process", 0, 50), _u("engine.process", 2, 46), _u("kernels.mac", 10, 20),
               _u("render.process", 50, 50), _u("engine.process", 52, 46), _u("kernels.mac", 60, 12)])
    run = _run("closed", t, 8, 4)
    assert least_us_per_block(run, "kernels.mac", call="engine.process") == pytest.approx(12 / 4)
    assert least_us_per_block(run, "engine.process", less="kernels.mac", call="engine.process") == \
        pytest.approx(26 / 4)
    assert least_us_per_block(run, "kernels.mac") is None


def test_idle_time_splits_by_the_program_span(traced_run):
    # idle 26 of 200 µs: conv.dcfix 8 + 3, conv.process 1, kernels.fused_stream 10, render.process 4
    assert read("device.idle.render", traced_run) == pytest.approx(13.0)
    glue = read("engine.idle_in_glue.render", traced_run)
    launch = read("kernels.idle_in_launch.render", traced_run)
    assert glue == pytest.approx(6.0) and launch == pytest.approx(5.0)
    assert glue + launch <= read("device.idle.render", traced_run)


def test_filter_seconds_sum_the_filter_and_bind_spans(monkeypatch):
    totals = {"conv.filter": {"calls": 1, "host_s": 1.5, "self_s": 1.5},
              "conv.bind": {"calls": 1, "host_s": 0.25, "self_s": 0.25},
              "conv.process": {"calls": 9, "host_s": 4.0, "self_s": 1.0}}
    monkeypatch.setattr(neojax_torch.trace, "totals", lambda: totals)
    assert read("api.filter_s.render", _run("closed", None, 0, 4)) == pytest.approx(1.75)
    monkeypatch.setattr(neojax_torch.trace, "totals", lambda: {"conv.process": totals["conv.process"]})
    assert read("api.filter_s.render", _run("closed", None, 0, 4)) is None


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    # the benchmark's own spans only, as a program without neojax_torch.trace leaves the trace
    t = Trace([_u("render.process", 0, 10), _u("render.process", 10, 10), _x("kernel", "a", 0, 30)])
    run = _run("closed", t, 8, 4)
    for name in SPAN_READERS:
        assert read(name, run) is None
    monkeypatch.delattr(neojax_torch, "trace")
    monkeypatch.setitem(sys.modules, "neojax_torch.trace", None)
    assert read("api.filter_s.render", run) is None


def test_untraced_runs_read_nothing():
    run = types.SimpleNamespace(traffic={"loop": "closed", "call_blocks": 4}, window=Window(), trace=None)
    for name in SPAN_READERS:
        assert read(name, run) is None


@pytest.mark.parametrize("mix", RENDER_MIXES)
def test_a_traced_render_run_reports_the_program_spans(mix, device):
    line = tiny.run(mix, 2**31 + 11, device=device, traced=True)
    got = line["metrics"]
    assert got["api.filter_s.render"]["value"] > 0
    for name in ("engine.glue_host_us_per_block.render", "kernels.launch_host_us_per_block.render"):
        assert got[name]["value"] > 0
    if device == "cuda":
        idle = got["device.idle.render"]["value"]
        assert got["engine.idle_in_glue.render"]["value"] + got["kernels.idle_in_launch.render"]["value"] <= idle
        labels = {label for label, _ in line["breakdown"]["idle_gaps"]}
        assert labels & {"conv.process", "conv.dcfix", "kernels.fused_stream"}
    assert line["correct"]
