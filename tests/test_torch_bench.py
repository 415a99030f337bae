"""neojax_torch.bench against neojax.bench and bench.py on the CPU.

- ``sparse_quality_sweep`` at block 64, STFT 64, 2 channels, 3 thresholds:
  the densities equal neojax's exactly (the same masks), and each RMSE is
  within 1e-4 relative of neojax's (both convolve in complex64 on the CPU,
  in other summation orders; the RMSEs here are 1e-2 to 1, so 1e-4 is ten
  times the float32 spread of a 64-bin spectrogram);
- ``spectrum`` and ``fft_flops`` exactly;
- ``headline``: the IR, the partitioned spectra and ``perblock_bytes``
  equal ``bench.py``'s exactly, for all five storages, fused and not; the
  kernels' work models agree with their schedules' dense limits;
- ``RunRecord`` has neojax's fields, and ``profile.trace`` writes a trace;
- the harness refuses to time without a card.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import bench  # noqa: E402
from neojax.bench import profile as jprofile  # noqa: E402
from neojax.bench import quality as jquality  # noqa: E402
from neojax.bench import spectrum as jspectrum  # noqa: E402
from neojax.conv import convolver as jcv  # noqa: E402
from neojax_torch import bench as tbench  # noqa: E402
from neojax_torch.bench import harness, headline  # noqa: E402
from neojax_torch.bench import profile as tprofile  # noqa: E402
from neojax_torch.bench import spectrum as tspectrum  # noqa: E402
from neojax_torch.conv import convolver as tcv  # noqa: E402
from neojax_torch.kernels import fdl_mac as tmac  # noqa: E402
from neojax_torch.kernels import fused_step as tfs  # noqa: E402
from neojax_torch.kernels import sparse_mac as tsm  # noqa: E402

_STORAGES = ["dense", "split", "bf16", "int16", "int8"]


def test_sparse_quality_sweep_matches_neojax(rng):
    sig = rng.uniform(-1, 1, (2, 1024)).astype(np.float32)
    t = np.arange(512)
    ir = (rng.standard_normal((2, 512)) * np.exp(-t / 96.0)).astype(np.float32)
    kw = dict(sample_rate=48000.0, block_size=64, stft_size=64, thresholds_db=[-10.0, -30.0, -60.0])
    want = jquality.sparse_quality_sweep(sig, ir, **kw)
    got = tbench.sparse_quality_sweep(sig, ir, device="cpu", **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.threshold_db == w.threshold_db
        assert g.density == w.density
        assert abs(g.rmse - w.rmse) <= 1e-4 * w.rmse
        assert abs(g.rmse_db - w.rmse_db) <= 1e-3
    assert [p.density for p in got] == sorted(p.density for p in got)  # a lower threshold keeps more


def test_max_channel_rms_error_matches_neojax(rng):
    a = rng.standard_normal((3, 5, 7)) + 1j * rng.standard_normal((3, 5, 7))
    b = a + 0.1 * rng.standard_normal((3, 5, 7))
    assert tbench.max_channel_rms_error(a, b) == jquality.max_channel_rms_error(a, b)


def test_spectrum_matches_neojax_exactly(rng):
    parts = (rng.standard_normal((2, 6, 33)) + 1j * rng.standard_normal((2, 6, 33))).astype(np.complex64)
    parts[0, 0, :4] = 0
    np.testing.assert_array_equal(tspectrum.power_spectrum_image(parts), jspectrum.power_spectrum_image(parts))
    for got, want in zip(tspectrum.db_histogram(parts, 48), jspectrum.db_histogram(parts, 48)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,batch", [(2, 1), (1024, 1), (4096, 64), (100, 3)])
def test_fft_flops_matches_neojax(n, batch):
    from neojax.bench import harness as jharness

    assert harness.fft_flops(n, batch) == jharness.fft_flops(n, batch)


def test_headline_ir_and_parts_match_bench():
    np.testing.assert_array_equal(headline.make_ir(), bench._make_ir())
    np.testing.assert_array_equal(headline.make_ir(8, 64), bench._make_ir(8, 64))
    np.testing.assert_array_equal(headline.make_parts(8, 65), bench._make_parts(8, 65))
    assert (headline.SR, headline.BLOCK, headline.CHANNELS, headline.P_REAL) == (
        bench.SR, bench.BLOCK, bench.CHANNELS, bench.P_REAL)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("p,packed", [(960, None), (32, None), (30, False)])
def test_perblock_bytes_matches_bench(storage, fused, p, packed):
    if packed is False and storage == "dense":
        packed = None
    jcfg = jcv.PartitionedConfig(512, p, 64, storage=storage, packed=packed)
    tcfg = tcv.PartitionedConfig(512, p, 64, storage=storage, packed=packed)
    assert headline.perblock_bytes(tcfg, p, fused) == bench._perblock_bytes(jcfg, p, fused)


def test_headline_signal_is_seeded():
    a = headline.signal(3, "cpu", channels=2, block=8)
    assert a.shape == (2, 24) and a.dtype == torch.float32
    assert torch.equal(a, headline.signal(3, "cpu", channels=2, block=8))
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0


def test_work_models_at_the_headline_shape():
    # B1 split: the 251.7 MB ring + 3.9 MB of shared filter + 0.3 MB out
    w = headline.fdl_mac_work("split", 960, 64, 512)
    assert w.bytes == 2 * 960 * 64 * 512 * 4 + 2 * 960 * 512 * 4 + 2 * 64 * 512 * 4
    t, by = headline.bound(w, 3.35e12, 67e12)
    assert by == "bytes" and 75e-6 < t < 78e-6
    # B3 over 64 blocks: the dense default equals a dense chunk schedule
    mask = np.ones((32, 1, 65), bool)
    pc = tfs.fused_chunk_rows(torch.float32, 32, 4, 64)
    sch = tsm.build_chunk_schedule(mask, pc, lanes=64)
    for pos0, rim_rows in ((0, 32 + 8 - 1), (29, 2 * 32 - 1)):  # from 29 the rotations wrap
        visits = headline.chunk_visits(sch["c_idx"], sch["flags"], pos0, 8, pc, 64)
        assert visits == (32 * 64, rim_rows * 64, [32 * 64] * 8)
        assert headline.fused_stream_work("int8", 32, 4, 64, 8, visits=visits) == \
            headline.fused_stream_work("int8", 32, 4, 64, 8, pos0=pos0)
    # B4 over a full tile schedule visits every (row, lane) pair of K = 65
    k_tile, p_chunk = tmac.choose_chunks(torch.float32, 32, 4, 65)
    tab = tsm.build_sparse_schedule(mask, p_chunk, k_tile)
    assert headline.tile_live(tab["k_idx"][3], tab["p_idx"][3], tab["flags"][3], p_chunk, k_tile, 65) == (32 * 65, 32)
    assert headline.sparse_fdl_mac_work("int16", 4, 65, 32 * 65, 32) == headline.fdl_mac_work("int16", 32, 4, 65)
    # T2: empty writes only; win_fwd_inv adds the inverse's matrix and work
    e = headline.stream_probe_work(4, 64, 512, 64, "empty")
    f = headline.stream_probe_work(4, 64, 512, 64, "win_fwd")
    i = headline.stream_probe_work(4, 64, 512, 64, "win_fwd_inv")
    assert e.flops == 0 and e.bytes == 64 * 64 * 512 * 4
    assert i.bytes - f.bytes == 2 * 512 * 512 * 4 and i.flops > f.flops > 0
    # the transforms count as real FFTs (2.5 N log2 N), not as the kernels'
    # dense GEMVs: B3 is then bound by its MAC, T2 by its bytes
    rfft = harness.fft_flops(1024) // 2
    assert rfft == 25600 and i.flops == 64 * 64 * 2 * rfft
    b3 = headline.fused_stream_work("split", 960, 64, 512, 64, pos0=955)
    assert b3.flops == 64 * 64 * (2 * rfft + 8 * 960 * 512)
    t, by = headline.bound(b3, 3.35e12, 67e12)
    assert by == "operations" and 0.24e-3 < t < 0.25e-3
    assert headline.bound(i, 3.35e12, 67e12)[1] == "bytes"
    # B5: int8 keeps 64 group scales a meta-bin row, int16 one
    q8, q16 = (headline.nested_mac_work(s, 8, 4, 65, 256) for s in ("int8", "int16"))
    assert q16.bytes - q8.bytes == 2 * 8 * 4 * 65 * 256 - 8 * 4 * 65 * 63 * 4


def test_run_record_has_neojax_fields():
    tfields = [f.name for f in dataclasses.fields(tprofile.RunRecord)]
    jfields = [f.name for f in dataclasses.fields(jprofile.RunRecord)]
    assert tfields == jfields
    rec = tprofile.RunRecord("perblock/split", {"block": 512}, samples_per_sec=1.5, snr_db=90.0)
    assert set(json.loads(rec.to_json())) == set(jfields)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tprofile.trace(str(tmp_path / "t")) as prof:
        torch.ones(16).sum()
    assert (tmp_path / "t" / "trace.json").exists() and prof is not None


@pytest.mark.parametrize("call", [
    lambda: harness.measure("x", lambda: None),
    lambda: harness.hbm_peak_bytes_per_sec(),
    lambda: harness.hbm_achievable_bytes_per_sec(1024),
    lambda: harness.memcpy_probe(1024),
    lambda: harness.multiply_add_probe(1024),
    lambda: harness.slope_seconds(lambda n: None, (1, 2)),
])
def test_harness_refuses_without_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
