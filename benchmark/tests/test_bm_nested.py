"""The nested int8 render as a listed cell (``ambi64_10s_int8.nested_render``):
its configuration is the test fixture's, it builds the nested engine
through ``make_engine``, it is correct and its control is not, and it
reports the engine readers and the three readers of the nested engine's
own spans and of B5's roofline (``benchmark/lib/work_nested.py``), each
exact on hand-made traces and silent where its spans or B5's operations
are absent. A fault planted in the nested engine is caught."""

import types

import pytest

import neojax_torch.conv
from benchmark.lib import runner, spec, work_nested
from benchmark.tests.test_bm_faults import answer_altered, half_left_out, state_unchanged
from benchmark.lib.trace import Trace
from benchmark.lib.traffic import Window
from benchmark.tests import tiny
from benchmark.tests.test_bm_readers import _run, _x, read
from neojax_torch.conv import nested

NAME = "ambi64_10s_int8"
CELL = "ambi64_10s_int8.nested_render"
FIXTURE = "benchmark/tests/configs/ambi64_10s_int8.json"
NEW = ("engine.nested_glue_host_us_per_block.render", "engine.idle_in_nested.render",
       "kernels.nested_mac_roofline.render")
ENGINE_READERS = ("api.enqueue_us_per_block.render", "engine.launches_per_block.render", "kernels.roofline.render",
                  "device.idle.render")
B5 = "void nested_mac_kernel<signed char>(signed char const*, float const*)"
# a configuration whose B5 launch moves 480 bytes: P2 = ceil(5 / 4) = 2, C = 1, K = 2, 2S = 8, int8
SMALL = {"storage": "int8", "chunk_blocks": 4, "ring_partitions": 5, "channels": 1, "block": 1}


def _u(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def test_the_listed_configuration_is_the_fixture():
    listed, fixture = spec.load_json(spec.config_file(NAME)), spec.load_json(spec.ROOT / FIXTURE)
    assert {k: v for k, v in listed.items() if k != "assumed"} == {k: v for k, v in fixture.items() if k != "assumed"}
    assert (listed["engine"], listed["storage"], listed["chunk_blocks"], listed["channels"]) == ("nested", "int8", 128, 64)
    assert (listed["ring_partitions"], listed["ir"]["partitions"], listed["block"]) == (960, 938, 512)
    entry = next(c for c in spec.benchmark()["configs"] if c["name"] == NAME)
    assert entry["reduced"] == [] and len(entry["source"]) <= 200


def test_the_cell_reports_the_engine_readers_and_the_new_ones():
    cell = spec.cell(CELL)
    assert [m["name"] for m in cell["end_to_end"]] == ["render_msps", "setup_s"]
    assert {m["name"] for m in cell["per_layer"]} == set(ENGINE_READERS + NEW)
    assert cell["traffic"]["call_blocks"] == 1024 and cell["workload"]["chips"] == 1


def test_b5_least_bytes_at_the_listed_configuration():
    config = spec.load_json(spec.config_file(NAME))
    ring, scales, filt, acc = 134_479_872, 67_239_936, 8_404_992, 67_239_936
    assert ring == 2 * 8 * 64 * 513 * 256 and scales == 8 * 64 * 513 * 64 * 4
    assert filt == 2 * 8 * 513 * 256 * 4 and acc == 2 * 64 * 513 * 256 * 4
    assert work_nested.least_bytes_per_launch(config) == ring + scales + filt + acc == 277_364_736


@pytest.mark.parametrize("storage,want", [("int8", 64 * 1 + 8 * 4 + 384), ("int16", 64 * 2 + 4 * 4 + 384),
                                          ("bf16", 64 * 2 + 384), ("split", 64 * 4 + 384)])
def test_b5_least_bytes_by_storage(storage, want):
    """``SMALL``: the ring's 2 P2 C K 2S = 64 entries at the storage's
    bytes; the scales of the 4 meta rows, two a row (int8, one a 4
    meta-bins) or one (int16); the filter's 2 P2 K 2S = 64 and the
    accumulator's 2 C K 2S = 32 float32 (384 bytes)."""
    assert work_nested.least_bytes_per_launch({**SMALL, "storage": storage}) == want


def _nested_run(trace, config=None):
    run = _run("closed", trace, 8, 4)
    run.config = {**SMALL, **(config or {})}
    return run


@pytest.fixture
def traced_run():
    # two calls of 4 blocks, each two chunks; device busy 0-10, 20-40, 45-50, 100-130, 140-150, 160-200 µs
    t = Trace([
        _u("render.process", 0, 100), _u("nested.process", 2, 96),
        _u("nested.forward", 5, 10), _u("nested.push", 15, 5), _u("kernels.nested_mac", 20, 10),
        _u("nested.inverse", 30, 10), _u("nested.forward", 40, 10), _u("nested.push", 50, 5),
        _u("kernels.nested_mac", 55, 15), _u("nested.inverse", 70, 20),
        _u("render.process", 100, 100), _u("nested.process", 101, 95),
        _u("kernels.nested_mac", 110, 4), _u("kernels.nested_mac", 150, 6),
        _x("kernel", "a", 0, 10), _x("kernel", B5, 20, 20), _x("kernel", "b", 45, 5),
        _x("kernel", B5, 100, 30), _x("kernel", "c", 140, 10), _x("kernel", B5, 160, 40),
    ])
    return _nested_run(t)


def test_the_glue_is_the_least_host_time_outside_b5(traced_run):
    # 96 - 25 = 71 and 95 - 10 = 85 µs a call of 4 blocks
    assert read(NEW[0], traced_run) == pytest.approx(71 / 4)


def test_idle_in_the_nested_spans_splits_the_device_idle(traced_run):
    # idle 85 of 200 µs: 10-20 (forward 10-15, push 15-20), 40-45 (forward), 50-100 (push 50-55,
    # B5's wrapper 55-70, inverse 70-90, nested.process 90-98, render.process 98-100), 130-140
    # (nested.process), 150-160 (B5's wrapper 150-156, nested.process 156-160): in the engine's
    # own spans forward 10, push 10, inverse 20, nested.process 22 µs
    assert read("device.idle.render", traced_run) == pytest.approx(42.5)
    assert read(NEW[1], traced_run) == pytest.approx(100 * 62 / 200)
    assert read(NEW[1], traced_run) <= read("device.idle.render", traced_run)


def test_b5_roofline_is_its_least_time_over_its_device_time(traced_run):
    # three B5 launches of 480 bytes at 3.35 TB/s over 90 µs of B5
    assert read(NEW[2], traced_run) == pytest.approx(100 * 3 * 480 / 3.35e12 / 90e-6)


def test_without_the_spans_or_b5_the_new_readers_read_nothing():
    # a parent's trace: the benchmark's spans, B5 launched, none of the program's nested spans
    t = Trace([_u("render.process", 0, 50), _u("render.process", 50, 50), _x("kernel", B5, 0, 40),
               _x("kernel", "a", 60, 10)])
    run = _nested_run(t)
    assert read(NEW[0], run) is None and read(NEW[1], run) is None
    assert read(NEW[2], run) == pytest.approx(100 * 480 / 3.35e12 / 40e-6)
    # no B5 in the trace (a Convolver run), or a configuration with no meta ring
    t = Trace([_u("render.process", 0, 50), _u("conv.process", 1, 40), _x("kernel", "stream_mac_kernel", 0, 40)])
    assert all(read(n, _nested_run(t)) is None for n in NEW)
    run = _nested_run(Trace([_u("render.process", 0, 50), _x("kernel", B5, 0, 40)]))
    run.config = {"storage": "split", "ring_partitions": 960, "channels": 64, "block": 512}
    assert read(NEW[2], run) is None
    untraced = types.SimpleNamespace(traffic={"loop": "closed", "call_blocks": 4}, window=Window(), trace=None,
                                     config=SMALL, hbm_bytes_per_s=3.35e12)
    assert all(read(n, untraced) is None for n in NEW)


def test_the_cell_builds_the_nested_engine_through_make_engine(monkeypatch):
    built = []
    real = neojax_torch.conv.make_engine

    def engine(kind, partitions, **kw):
        built.append((kind, kw["storage"], kw["chunk_blocks"], kw["channels"], tuple(partitions.shape)))
        return real(kind, partitions, **kw)

    monkeypatch.setattr(neojax_torch.conv, "make_engine", engine)
    res = tiny.run((NAME, "render"), 2**31 + 33)
    assert res["correct"] is True and built == [("nested", "int8", 8, 2, (1, 32, 65))]


def test_the_listed_configuration_is_correct(device):
    res = tiny.run((NAME, "render"), 2**31 + 21, device)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]


def test_the_listed_configurations_control_is_not_correct(device):
    res = tiny.run((NAME, "render"), 2**31 + 5, device, control=True)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
def test_a_fault_in_the_listed_configurations_engine_is_caught(fault, device, monkeypatch):
    """The faults of ``test_bm_faults.py`` planted in the nested engine's
    core, which this configuration's ``process`` runs (not the
    Convolver's)."""
    monkeypatch.setattr(nested, "process_nested", fault(nested.process_nested))
    res = tiny.run((NAME, "render"), 2**31 + 99, device)
    assert res["correct"] is False and res["failed"] == 0, res["checks"]


def test_a_traced_run_of_the_cell_reads_the_new_metrics(device, monkeypatch):
    """On the CPU only the host-time reader finds something (the trace holds
    no device operation); on the card all three read numbers, the idle
    inside the device's and the roofline share within 0-100 %."""
    runs = []

    class Kept(runner.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)

    monkeypatch.setattr(runner, "Run", Kept)
    line = tiny.run((NAME, "render"), 2**31 + 13, device, traced=True)
    assert line["correct"] is True
    (run,) = runs
    got = {n: read(n, run) for n in NEW}
    assert got[NEW[0]] > 0 and line["metrics"][NEW[0]]["value"] == got[NEW[0]]
    if device == "cpu":
        assert got[NEW[1]] is None and got[NEW[2]] is None
    else:
        assert 0 <= got[NEW[1]] <= line["metrics"]["device.idle.render"]["value"]
        assert 0 < got[NEW[2]] <= 100
    assert set(line["metrics"]) <= set(ENGINE_READERS + NEW)
