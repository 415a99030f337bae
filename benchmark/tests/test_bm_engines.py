"""Configurations that name an engine of ``make_engine`` (``engine``,
``chunk_blocks``; ``benchmark/lib/spec.py``): each of the four runs from a
fixture file (``benchmark/tests/configs/``) through ``runner.run_cell``,
with no other file of the harness edited, and reads ``correct``; its
output follows the ``Convolver``'s on the same filter and stream; a mix it
cannot take is refused when the cell is resolved. The two listed
configurations build the ``Convolver`` exactly as before, and their small
sizes stay as they were."""

import json
import time

import pytest
import torch

import neojax_torch.conv
from benchmark.lib import inputs, runner, spec, system
from benchmark.tests import tiny
from neojax_torch.conv import convolver as cv

ENGINES = ("perblock", "nested", "chunked", "hybrid")
FIXTURE = {e: f"benchmark/tests/configs/ambi64_10s_split_{e}.json" for e in ENGINES}
INT8 = "benchmark/tests/configs/ambi64_10s_int8.json"
FIXTURES = list(FIXTURE.values()) + [INT8]
# the Convolver configurations BENCHMARK.json lists (later ones may name an engine)
LISTED = ["ambi64_10s_split", "ambi64_room10s_perc60_bf16"]


def _tiny(config_file):
    """The configuration and render mix of a fixture at the small sizes."""
    cell = spec.cell_for(config_file, "render")
    ov = tiny.overrides(cell)
    return {**cell["config"], **ov["config"]}, {**cell["traffic"], **ov["traffic"]}


@pytest.mark.parametrize("config_file", FIXTURES)
def test_an_engine_render_is_correct(config_file, device):
    res = tiny.run((config_file, "render"), 2**31 + 21, device)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("config_file", FIXTURES)
def test_an_engine_control_is_not_correct(config_file, device):
    res = tiny.run((config_file, "render"), 2**31 + 5, device, control=True)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("config_file", FIXTURES)
def test_an_engine_follows_the_convolver_on_the_same_filter_and_stream(config_file):
    """Three calls (96 blocks, three times around the 32-partition ring),
    every output sample held to ``ambi64_10s_split``'s Convolver (split
    float32) on the same filter, within the configuration's limits."""
    config, traffic = _tiny(config_file)
    filt = inputs.make_filter(config)
    stream = inputs.make_stream(config, traffic, 2**31 + 3, None, "cpu")
    engine = system.build(config, filt, "cpu")
    conv = system.build({**config, "engine": "convolver", "storage": "split"}, filt, "cpu")
    assert isinstance(engine, neojax_torch.conv.Engine) and isinstance(conv, cv.Convolver)
    for i in range(3):
        x = stream.call_input(i)
        want, got = conv.process(x).double(), engine.process(x).double()
        rms = float(want.pow(2).mean().sqrt())
        assert float((got - want).pow(2).mean().sqrt()) / rms <= config["limits"]["rel_rms_err"]
        assert float((got - want).abs().max()) / rms <= config["limits"]["max_err_over_rms"]


@pytest.mark.parametrize("config_file", FIXTURES)
def test_an_engine_takes_only_the_mixes_that_call_process(config_file):
    assert spec.mixes(config_file) == ["render"]
    with pytest.raises(ValueError, match="no per-block entry"):
        spec.cell_for(config_file, "live")


@pytest.mark.parametrize("name", LISTED)
def test_the_convolver_takes_every_mix(name):
    assert spec.mixes(name) == ["live", "render"]
    assert all(mix in tiny.MIXES for mix in ((name, "live"), (name, "render")))


def test_a_call_of_part_of_a_chunk_is_refused(tmp_path):
    config = spec.load_json(spec.ROOT / FIXTURE["nested"])
    path = tmp_path / "nested96.json"
    path.write_text(json.dumps({**config, "chunk_blocks": 96}))
    with pytest.raises(ValueError, match="call_blocks 1024 is not a multiple of chunk_blocks 96"):
        spec.cell_for(str(path), "render")
    assert spec.mixes(str(path)) == []
    # at the small sizes too, once the overrides are in
    cell = spec.cell_for(FIXTURE["nested"], "render")
    ov = tiny.overrides(cell)
    ov["traffic"]["call_blocks"] = 12
    with pytest.raises(ValueError, match="call_blocks 12 is not a multiple of chunk_blocks 8"):
        runner.run_cell(cell, 1, 0.1, False, time.perf_counter(), device="cpu", overrides=ov)


def test_a_chunked_engine_without_chunk_blocks_is_refused(tmp_path):
    config = spec.load_json(spec.ROOT / FIXTURE["hybrid"])
    del config["chunk_blocks"]
    path = tmp_path / "hybrid.json"
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError, match="needs chunk_blocks"):
        spec.cell_for(str(path), "render")


@pytest.mark.parametrize("name", LISTED)
def test_a_listed_configuration_builds_the_convolver_as_before(name, monkeypatch):
    """``Convolver(scheme, storage, sparsity=mask, require_sparsity=..., device=...)``
    then ``filter(spectra[None], pad_partitions=ring_partitions)``, and
    nothing of ``make_engine``; the control's storage in the configuration's
    place."""
    calls = []

    def init(self, *args, **kw):
        calls.append(("init", args, kw))

    def filt_(self, *args, **kw):
        calls.append(("filter", args, kw))

    def engine(*args, **kw):
        raise AssertionError("make_engine called for a Convolver configuration")

    monkeypatch.setattr(cv.Convolver, "__init__", init)
    monkeypatch.setattr(cv.Convolver, "filter", filt_)
    monkeypatch.setattr(neojax_torch.conv, "make_engine", engine)
    config = spec.cell_for(name, "render")["config"]
    filt = inputs.make_filter({**config, **tiny.overrides(spec.cell_for(name, "render"))["config"]})
    for storage in (None, "int8"):
        calls.clear()
        conv = system.build(config, filt, "cpu", storage)
        assert isinstance(conv, cv.Convolver)
        (k0, a0, kw0), (k1, a1, kw1) = calls
        assert (k0, a0) == ("init", (config["scheme"], storage or config["storage"]))
        assert kw0 == {"sparsity": filt.mask, "require_sparsity": filt.mask is not None, "device": "cpu"}
        assert k1 == "filter" and len(a1) == 1 and kw1 == {"pad_partitions": config["ring_partitions"]}
        assert torch.equal(torch.from_numpy(a1[0]), torch.from_numpy(filt.spectra[None]))


def test_an_engine_control_builds_the_engine_at_the_lower_storage(monkeypatch, tmp_path):
    config = spec.load_json(spec.ROOT / FIXTURE["nested"])
    path = tmp_path / "nested_bf16.json"
    path.write_text(json.dumps({**config, "storage": "bf16", "control": {"kind": "program", "storage": "int8"}}))
    built = []
    real = neojax_torch.conv.make_engine

    def engine(kind, partitions, **kw):
        built.append((kind, kw["storage"], kw["chunk_blocks"], kw["channels"], tuple(partitions.shape)))
        return real(kind, partitions, **kw)

    monkeypatch.setattr(neojax_torch.conv, "make_engine", engine)
    tiny.run((str(path), "render"), 2**31 + 7)
    tiny.run((str(path), "render"), 2**31 + 7, control=True)
    # the spectra zero-padded from the IR's 30 partitions to the ring's 32
    assert built == [("nested", "bf16", 8, 2, (1, 32, 65)), ("nested", "int8", 8, 2, (1, 32, 65))]


def test_the_small_sizes_of_the_listed_configurations_stay():
    base = {"channels": 2, "block": 64, "sample_rate": 4800, "ring_partitions": 24}
    want = {"ambi64_10s_split": {"generator": "decaying_noise", "partitions": 20, "seed": 0},
            "ambi64_room10s_perc60_bf16": {"generator": "octave_room", "partitions": 24, "seed": 0}}
    assert set(want) == set(LISTED) <= {c["name"] for c in spec.benchmark()["configs"]}
    for name, ir in want.items():
        ov = tiny.overrides(spec.cell_for(name, "render"))
        assert ov == {"config": {**base, "ir": ir},
                      "traffic": {"call_blocks": 32, "trace_calls": 2, "enqueue_calls": 2}}
        assert tiny.overrides(spec.cell_for(name, "live"))["traffic"] == {"trace_calls": 8}


def test_a_configuration_brings_its_own_small_sizes():
    ov = tiny.overrides(spec.cell_for(INT8, "render"))["config"]
    assert ov == {"channels": 2, "block": 64, "sample_rate": 4800, "ring_partitions": 32, "chunk_blocks": 8,
                  "ir": {"generator": "decaying_noise", "partitions": 30, "seed": 0}}


def test_every_reader_reads_a_number_or_nothing_on_a_traced_nested_run(monkeypatch):
    """After a Convolver run in the same process (whose spans and counters
    the run's reset clears), every reader of ``benchmark/metrics/`` on a
    traced nested run; those of the Convolver's own spans and counters read
    nothing."""
    tiny.run(("ambi64_10s_split", "render"), 2**31 + 1, traced=True)
    runs = []

    class Kept(runner.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)

    monkeypatch.setattr(runner, "Run", Kept)
    res = tiny.run((FIXTURE["nested"], "render"), 2**31 + 1, traced=True)
    assert res["correct"] is True
    (run,) = runs
    got = {}
    for path in sorted((spec.PKG / "metrics").glob("*.py")):
        value = spec.metric_reader(path.stem)(run)
        assert value is None or isinstance(value, float), (path.stem, value)
        got[path.stem] = value
    for name in ("api.filter_s.render", "kernels.mac_step_share.render", "engine.glue_host_us_per_block.render",
                 "kernels.launch_host_us_per_block.render", "engine.idle_in_glue.render",
                 "kernels.idle_in_launch.render", "callback_p50_us", "callback_p99_us"):
        assert got[name] is None, name
    assert got["render_msps"] > 0 and got["setup_s"] > 0 and got["api.enqueue_us_per_block.render"] > 0
    # an unlisted render cell reports what the listed render cells report
    assert set(res["metrics"]) <= {m["name"] for m in spec.cell_for(FIXTURE["nested"], "render")["per_layer"]}
