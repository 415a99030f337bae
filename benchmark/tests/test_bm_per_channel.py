"""One filter a channel (``ir.per_channel``): the inputs make one IR a
channel, the plain reference convolves each channel with its own, the
system gets the filter as ``[C, P, K]`` through the Convolver and the
nested engine, and the least bytes count every channel's filter. Both
fixtures (``benchmark/tests/configs/per_channel_split*.json``) read
``correct`` at the small sizes; a filter whose channels are reversed, or
channel 0's filter given to every channel, reads ``correct`` false."""

import json

import numpy as np
import pytest
import torch

from benchmark.lib import inputs, spec, system, work, work_nested
from benchmark.reference import upols
from benchmark.tests import tiny

FIXTURES = ["benchmark/tests/configs/per_channel_split.json", "benchmark/tests/configs/per_channel_split_nested.json"]
B = 16


def _tiny_config(config_file):
    cell = spec.cell_for(config_file, "render")
    return {**cell["config"], **tiny.overrides(cell)["config"]}


def _stream(x):
    def segment(g0, g1):
        lo = max(g0, 0)
        seg = torch.from_numpy(x[:, lo * B : g1 * B])
        return torch.nn.functional.pad(seg, ((lo - g0) * B, 0))
    return segment


def test_the_fixtures_are_the_split_deployment_with_one_ir_a_channel():
    split = spec.load_json(spec.config_file("ambi64_10s_split"))
    for path in FIXTURES:
        config = spec.load_json(spec.ROOT / path)
        assert config["ir"] == {**split["ir"], "per_channel": True}
        assert {k: config[k] for k in ("channels", "block", "storage", "ring_partitions", "control", "limits")} == \
            {k: split[k] for k in ("channels", "block", "storage", "ring_partitions", "control", "limits")}
    assert spec.engine(spec.load_json(spec.ROOT / FIXTURES[1])) == "nested"


@pytest.mark.parametrize("config_file", FIXTURES)
def test_the_filter_is_one_ir_a_channel_from_the_one_seed(config_file):
    config = _tiny_config(config_file)
    filt = inputs.make_filter(config)
    c, p = config["channels"], config["ir"]["partitions"]
    assert filt.spectra.shape == filt.reference.shape == filt.live.shape == (c, p, config["block"] + 1)
    assert filt.mask is None
    rng = np.random.default_rng(config["ir"]["seed"])
    make = spec.module("irs", config["ir"]["generator"]).make
    irs = [make(rng, config) for _ in range(c)]
    for ch in range(c):
        assert np.array_equal(filt.spectra[ch], upols.partition(irs[ch], config["block"]))
    # channel 0 is the shared filter of the same seed; the others differ from it
    shared = inputs.make_filter({**config, "ir": {**config["ir"], "per_channel": False}})
    assert shared.spectra.shape == (p, config["block"] + 1)
    assert np.array_equal(filt.spectra[0], shared.spectra)
    assert not np.array_equal(filt.spectra[1], shared.spectra)


def test_a_per_channel_partition_is_each_channels_partition():
    irs = np.random.default_rng(5).standard_normal((3, 5 * B - 3)).astype(np.float32)
    got = upols.partition(irs, B)
    assert got.shape == (3, 5, B + 1) and got.dtype == np.complex64
    for ch in range(3):
        assert np.array_equal(got[ch], upols.partition(irs[ch], B))


def test_the_per_channel_reference_matches_np_convolve():
    rng = np.random.default_rng(6)
    c, taps = 3, 6 * B - 5
    irs = rng.standard_normal((c, taps))
    x = rng.standard_normal((c, 40 * B))
    p = -(-taps // B)
    padded = np.pad(irs, ((0, 0), (0, p * B - taps)))
    spectra = np.fft.rfft(padded.reshape(c, p, B), n=2 * B, axis=-1)  # complex128: no rounding of the filter
    blocks = [0, 1, 5, 6, 23, 39]
    ys = upols.output_blocks(_stream(x), spectra, blocks, B)
    full = np.stack([np.convolve(x[ch], irs[ch])[: x.shape[1]] for ch in range(c)])
    want = np.stack([full[:, g * B : (g + 1) * B] for g in blocks])
    got = np.stack([ys[g].numpy() for g in blocks])
    rms = float(np.sqrt(np.mean(want**2)))
    assert float(np.abs(got - want).max()) <= 1e-9 * rms


@pytest.mark.parametrize("precision,tol", [("f64", 1e-12), ("tf32", 1e-6), ("int4", 1e-6)])
def test_each_precision_takes_each_channels_own_filter(precision, tol):
    """Channel c of a per-channel reference is the shared-filter reference
    of channel c's filter, at each precision (the channels in chunks of 2,
    so that a chunk's channels come from its own rows)."""
    rng = np.random.default_rng(7)
    irs = rng.standard_normal((5, 4 * B)).astype(np.float32)
    x = rng.standard_normal((5, 30 * B)).astype(np.float32)
    spectra = upols.partition(irs, B)
    ys = upols.output_blocks(_stream(x), spectra, [9, 29], B, precision=precision, channel_chunk=2)
    for ch in range(5):
        one = upols.output_blocks(_stream(x[ch : ch + 1]), spectra[ch], [9, 29], B, precision=precision)
        for g in (9, 29):
            want = one[g][0]
            assert float((ys[g][ch] - want).abs().max()) <= tol * float(want.abs().max())


def test_a_per_channel_filter_for_another_channel_count_is_refused():
    spectra = upols.partition(np.ones((2, 2 * B), np.float32), B)
    x = np.zeros((3, 4 * B), np.float32)
    with pytest.raises(ValueError, match="2 channels of filter for 3 of input"):
        upols.output_blocks(_stream(x), spectra, [3], B)


@pytest.mark.parametrize("config_file", FIXTURES)
def test_a_per_channel_render_is_correct(config_file, device):
    res = tiny.run((config_file, "render"), 2**31 + 41, device)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]


def _planted(monkeypatch, change):
    real = system.build

    def build(config, filt, device, storage=None):
        return real(config, inputs.Filter(change(filt.spectra), filt.mask), device, storage)

    monkeypatch.setattr(system, "build", build)


@pytest.mark.parametrize("config_file", FIXTURES)
def test_the_channels_reversed_are_not_correct(config_file, device, monkeypatch):
    _planted(monkeypatch, lambda s: s[::-1].copy())
    res = tiny.run((config_file, "render"), 2**31 + 41, device)
    assert res["correct"] is False and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("config_file", FIXTURES)
def test_channel_0s_filter_for_every_channel_is_not_correct(config_file, device, monkeypatch):
    _planted(monkeypatch, lambda s: np.broadcast_to(s[:1], s.shape).copy())
    res = tiny.run((config_file, "render"), 2**31 + 41, device)
    assert res["correct"] is False and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("config_file", FIXTURES)
def test_a_per_channel_control_is_not_correct(config_file, device):
    res = tiny.run((config_file, "render"), 2**31 + 43, device, control=True)
    assert res["correct"] is False, res["checks"]


def test_the_system_gets_the_filter_a_channel(monkeypatch):
    """``Convolver.filter`` and ``make_engine`` get ``[C, P, K]`` as it is:
    the nested engine's zero-padded to the ring's partitions."""
    import neojax_torch.conv
    from neojax_torch.conv import convolver as cv

    got = {}
    real_filter, real_engine = cv.Convolver.filter, neojax_torch.conv.make_engine

    def filter_(self, partitions, **kw):
        got["convolver"] = (partitions, kw)
        return real_filter(self, partitions, **kw)

    def engine(kind, partitions, **kw):
        got[kind] = (partitions, kw)
        return real_engine(kind, partitions, **kw)

    monkeypatch.setattr(cv.Convolver, "filter", filter_)
    monkeypatch.setattr(neojax_torch.conv, "make_engine", engine)
    for path in FIXTURES:
        config = _tiny_config(path)
        system.build(config, inputs.make_filter(config), "cpu")
    split, nested = _tiny_config(FIXTURES[0]), _tiny_config(FIXTURES[1])
    parts, kw = got["convolver"]
    assert np.array_equal(parts, inputs.make_filter(split).spectra)
    assert kw == {"pad_partitions": split["ring_partitions"]}
    parts, kw = got["nested"]
    want = inputs.make_filter(nested).spectra
    pad = nested["ring_partitions"] - want.shape[1]
    assert parts.shape == (2, nested["ring_partitions"], nested["block"] + 1) and pad > 0
    assert np.array_equal(parts[:, : want.shape[1]], want) and not parts[:, want.shape[1] :].any()
    assert kw["channels"] == nested["channels"] and kw["sparsity"] is None


def test_the_least_bytes_of_the_fixture_by_hand():
    """The Convolver fixture at the small sizes: 2 channels, block 64, 20
    live partitions of 65 bins a channel, 32 blocks a call, split."""
    config = _tiny_config(FIXTURES[0])
    live = inputs.make_filter(config).live
    assert live.shape == (2, 20, 65) and live.all()
    io = 2 * 2 * 32 * 64 * 4
    filt = 2 * 20 * 65 * 8  # every channel's entries, complex float32
    state = 2 * (20 * 64 - 1) * 4
    got = work.least_bytes(2, 64, 32, live, "split", 0)
    assert got == io + filt + 2 * state  # the history read and written: less than the 2 * 32 * 64 new samples
    assert work.least_bytes(2, 64, 32, live, "split", state) == io + filt


def test_the_least_bytes_of_the_full_per_channel_deployment():
    """64 channels of 938 live partitions of 513 bins: the filter term is
    64 times the shared filter's, the rest as the split cell's."""
    onchip = work.PEAKS["NVIDIA H100 80GB HBM3"]["onchip_bytes"]
    shared = work.least_bytes(64, 512, 1024, np.ones((938, 513), bool), "split", onchip)
    per_channel = work.least_bytes(64, 512, 1024, np.ones((64, 938, 513), bool), "split", onchip)
    assert shared == 351_681_360
    assert per_channel == shared + 63 * 938 * 513 * 8 == 594_203_136


def test_p_live_is_the_deepest_partition_that_any_channel_keeps():
    live = np.zeros((3, 8, 5), bool)
    live[0, :2] = True
    live[2, 5, 1] = True  # channel 2 reaches partition 5: P_live = 6
    got = work.least_bytes(channels=3, block=4, call_blocks=1, live=live, storage="bf16", onchip_bytes=0)
    state = 3 * (6 * 4 - 1) * 2
    assert got == 2 * 3 * 4 * 4 + 11 * 2 * 2 + state + 3 * 4 * 2


def test_b5_least_bytes_count_every_channels_filter_planes():
    config = spec.load_json(spec.ROOT / FIXTURES[1])
    ring = 2 * 8 * 64 * 513 * 256 * 4
    filt = 64 * 2 * 8 * 513 * 256 * 4
    acc = 2 * 64 * 513 * 256 * 4
    assert work_nested.least_bytes_per_launch(config) == ring + filt + acc
    shared = {**config, "ir": {**config["ir"], "per_channel": False}}
    assert work_nested.least_bytes_per_launch(shared) == ring + filt // 64 + acc


def test_a_per_channel_mask_is_refused(tmp_path):
    masked = spec.load_json(spec.config_file("ambi64_room10s_perc60_bf16"))
    path = tmp_path / "masked_per_channel.json"
    path.write_text(json.dumps({**masked, "ir": {**masked["ir"], "per_channel": True}}))
    with pytest.raises(ValueError, match=r"ir\.per_channel and mask"):
        spec.cell_for(str(path), "render")
    assert spec.mixes(str(path)) == []
