"""The port's sweep tools (``neojax_torch.tools.{int8_sweep,
bench_sparse_sweep, bench_perceptual, bench_quality_sweep, bench_grid,
bench_timesharded}``), the perceptual example and the bench oracle, on
the CPU at small sizes, held against the ``neojax`` calls the JAX tools
make (``tools/*.py``, ``examples/perceptual_convolution.py``,
``bench.py``).

Each tool's row function runs here with ``device="cpu"`` (the kernels'
plain versions); their timings need the card, and ``main`` raises
without one. Tolerances, relative to the output peak: the nested file's
``_TOL`` (``tests/test_torch_nested.py``) for the int8 rows, the sparse
file's (``tests/test_torch_sparse.py``) for the masked rows, 2e-5 for
split (``tests/test_torch_convolver.py``).
"""

import importlib
import importlib.util
import os
import sys
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from neojax.bench import quality as jquality
from neojax.conv import convolver as jcv
from neojax.conv import nested as jnested
from neojax_torch.bench import headline
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import nested as tnested
from neojax_torch.conv.partition import uniform_partition
from neojax_torch.conv.sparse import perceptual_mask
from neojax_torch.tools import (bench_grid, bench_perceptual, bench_quality_sweep, bench_sparse_sweep,
                                bench_timesharded, int8_sweep)

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NESTED_TOL = {"split": 1e-5, "bf16": 5e-2, "int16": 1e-2, "int8": 1e-1}
_SPARSE_TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_SPLIT_TOL = 2e-5
_JAX_PREC = {"default": lax.Precision.DEFAULT, "high": lax.Precision.HIGH, "highest": lax.Precision.HIGHEST}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1e-30, np.abs(b).max()))


def _load_jax_tool(name):
    """A JAX tool's module by path (its top level imports no jax)."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ int8 sweep

_I8 = {"c": 4, "p": 64, "b": 64, "s": 32, "nb": 128, "start": 96, "blocks": 16}  # 2S = 64: G = 64 not clamped


def _i8_inputs():
    rng = np.random.default_rng(5)
    parts = headline.make_parts(_I8["p"], _I8["b"] + 1)
    sig = rng.uniform(-1, 1, (_I8["c"], _I8["nb"] * _I8["b"])).astype(np.float32)
    return parts, sig


def _jax_int8_row(storage, prec, groups, mac, parts, sig):
    """The JAX tool's ``run_row`` at this size: the same two patches, B5 in
    interpret mode for ``"pallas"`` (as ``tests/test_torch_nested.py``)."""
    saved = (dict(jnested._QUANT_GROUPS), jnested._fft_precisions)
    jnested._QUANT_GROUPS["int8"] = groups
    jnested._fft_precisions = lambda config: (_JAX_PREC[prec], _JAX_PREC[prec])
    jnested._INTERPRET = mac == "pallas"
    jax.clear_caches()
    try:
        cfg = jcv.PartitionedConfig(_I8["b"], _I8["p"], _I8["c"], storage=storage, mac_backend=mac)
        params = jnested.nested_filter_params(cfg, parts, _I8["s"])
        _, out = jax.jit(partial(jnested.process_nested, cfg))(params, jnested.nested_init_state(cfg, params),
                                                               jnp.asarray(sig))
        return np.asarray(out)
    finally:
        jnested._INTERPRET = False
        jnested._fft_precisions = saved[1]
        jnested._QUANT_GROUPS.clear()
        jnested._QUANT_GROUPS.update(saved[0])
        jax.clear_caches()


@pytest.mark.parametrize("name", ["int8/high/G16/xla", "int8/high/G64/pallas"])
def test_int8_row_matches_neojax(name):
    _, storage, prec, groups, mac = {g[0]: g for g in int8_sweep.GRID}[name]
    parts, sig = _i8_inputs()
    saved = (dict(tnested._QUANT_GROUPS), tnested._fft_precisions)
    got, sec = int8_sweep.run_row(storage, prec, groups, mac, s=_I8["s"], device=CPU, parts=parts,
                                  sig=torch.from_numpy(sig))
    assert sec is None
    assert tnested._QUANT_GROUPS == saved[0] and tnested._fft_precisions is saved[1]  # restored
    want = _jax_int8_row(storage, prec, groups, mac, parts, sig)
    assert got.shape == want.shape and _rel(got.numpy(), want) < _NESTED_TOL[storage]
    oracle = headline.oracle_head(sig, headline.make_ir(_I8["p"], _I8["b"]), _I8["start"], _I8["blocks"], _I8["c"],
                                  _I8["b"])
    lo, hi = _I8["start"] * _I8["b"], (_I8["start"] + _I8["blocks"]) * _I8["b"]
    snr_t = headline.snr_db(got.numpy()[:, lo:hi], oracle)
    snr_j = headline.snr_db(want[:, lo:hi], oracle)
    assert snr_t > 30.0 and abs(snr_t - snr_j) < 0.5, (snr_t, snr_j)


def test_int8_rows_high_and_highest_are_one_arithmetic():
    """On the port HIGH and HIGHEST are the same float32 FFT, so the pair of
    rows is bit-equal; a patched precision is restored even on error."""
    parts, sig = _i8_inputs()
    outs = [int8_sweep.run_row("int8", prec, 32, "xla", s=_I8["s"], device=CPU, parts=parts,
                               sig=torch.from_numpy(sig))[0] for prec in ("high", "highest")]
    assert torch.equal(*outs)
    saved = tnested._fft_precisions
    with pytest.raises(ValueError):
        int8_sweep.run_row("int8", "tf32", 32, "xla", device=CPU, parts=parts, sig=torch.from_numpy(sig))
    assert tnested._fft_precisions is saved
    names = [g[0] for g in int8_sweep.GRID]
    assert len(names) == 13 and set(int8_sweep.SMOKE) <= set(names)


# --------------------------------------------------------- bench oracle


def test_oracle_head_and_snr_match_bench_py(monkeypatch):
    """``bench.headline.oracle_head`` / ``snr_db`` against ``bench.py``'s
    ``_oracle_head`` / ``_snr_db`` on a short signal (the bench's own IR)."""
    import bench

    assert (headline.SNR_START, headline.SNR_BLOCKS, headline.SNR_CH) == (bench._SNR_START, bench._SNR_BLOCKS,
                                                                          bench._SNR_CH)
    rng = np.random.default_rng(3)
    sig = rng.uniform(-1, 1, (3, 6 * headline.BLOCK)).astype(np.float32)
    monkeypatch.setattr(bench, "_signal", lambda nb: sig[:, : nb * headline.BLOCK])
    monkeypatch.setattr(bench, "_SNR_START", 4)
    monkeypatch.setattr(bench, "_SNR_BLOCKS", 2)
    monkeypatch.setattr(bench, "_SNR_CH", 2)
    want = bench._oracle_head()
    got = headline.oracle_head(sig, start=4, blocks=2, channels=2)
    assert got.shape == want.shape == (2, 2 * headline.BLOCK)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(headline.oracle_head(torch.from_numpy(sig), start=4, blocks=2, channels=2), want)
    noisy = want + rng.standard_normal(want.shape) * 1e-3
    assert headline.snr_db(noisy, want) == bench._snr_db(noisy, want)
    assert headline.snr_db(want, want) == float("inf")


# ------------------------------------------------- perceptual: IR, spectro


def test_room_ir_is_the_jax_tools_bit_for_bit():
    jtool = _load_jax_tool("bench_perceptual")
    for p, b, seed in ((12, 512, 0), (8, 256, 3)):
        np.testing.assert_array_equal(bench_perceptual.room_ir(p, b, seed), jtool.room_ir(p, b, seed))


def test_spectro_is_the_jax_tools_formula():
    """``spectro`` bit-equal to the closure at ``tools/bench_perceptual.py:115-125``."""
    x = np.random.default_rng(4).uniform(-1, 1, (4, 32 * 512))

    def formula(x):  # tools/bench_perceptual.py:115-125
        x = np.asarray(x, np.float32)
        frame, tsz, hop = 1024, 2048, 512
        nf = (x.shape[-1] - frame) // hop + 1
        frames = np.stack([x[:, i * hop : i * hop + frame] for i in range(nf)], axis=1)
        return np.fft.rfft(frames, n=tsz, axis=-1)

    got = bench_perceptual.spectro(x)
    assert got.shape == (4, 31, 1025)
    np.testing.assert_array_equal(got, formula(x))


# ------------------------------------------------- sparse and perceptual rows


def _jax_process(cfg_kw, parts, mask, sig):
    jcfg = jcv.PartitionedConfig(**cfg_kw, mac_backend="xla")
    _, out = jcv.process(jcfg, jcv.filter_params(jcfg, parts, sparsity=mask), jcv.init_state(jcfg), jnp.asarray(sig))
    return np.asarray(out)


@pytest.mark.parametrize("storage", ["bf16", "split"])
@pytest.mark.parametrize("d", [0.3, None])
def test_sparse_row_matches_neojax(storage, d):
    b, p, c = 64, 32, 3
    parts = bench_sparse_sweep.make_parts(p, b)
    assert parts.shape == (1, p, b + 1)
    np.testing.assert_array_equal(bench_sparse_sweep.make_parts(), bench_sparse_sweep.make_parts(960, 512))
    mask = None if d is None else bench_sparse_sweep.band_mask(p, b + 1, d)
    if mask is not None:
        assert mask.sum() == int(p * d) * (b + 1)
    sig = np.random.default_rng(6).uniform(-1, 1, (c, 40 * b)).astype(np.float32)
    got = bench_sparse_sweep.process_row(parts, mask, torch.from_numpy(sig), storage)
    want = _jax_process(dict(block_size=b, num_partitions=p, channels=c, storage=storage), parts, mask, sig)
    assert _rel(got.numpy(), want) < _SPARSE_TOL[storage]


@pytest.mark.parametrize("storage", ["bf16", "split"])
def test_perceptual_row_matches_neojax(storage):
    b, c = 128, 2
    parts = uniform_partition(bench_perceptual.room_ir(24, b)[None], b)
    mask = perceptual_mask(parts[0], bench_perceptual.SR, -50.0)
    assert 0.05 < mask.mean() < 0.99  # bin-structured: some bins of some partitions dropped
    sig = np.random.default_rng(7).uniform(-1, 1, (c, 40 * b)).astype(np.float32)
    got = bench_sparse_sweep.process_row(parts, mask, torch.from_numpy(sig), storage)
    want = _jax_process(dict(block_size=b, num_partitions=24, channels=c, storage=storage), parts, mask, sig)
    assert _rel(got.numpy(), want) < _SPARSE_TOL[storage]
    dense = bench_sparse_sweep.process_row(parts, None, torch.from_numpy(sig), storage)
    np.testing.assert_array_equal(bench_perceptual.head(dense), dense.double().numpy()[:4, : 32 * 512])


def test_sparse_linear_fit():
    xs = [1 / 30, 0.1, 0.3, 0.5, 0.7, 1.0]
    fit = bench_sparse_sweep.linear_fit(xs, [3.5 + 12.25 * x for x in xs])
    assert fit["fixed_us"] == pytest.approx(3.5) and fit["fdl_us_at_dense"] == pytest.approx(12.25)
    assert fit["max_fit_residual_us"] < 1e-9
    ys = [4.0, 5.3, 7.1, 9.9, 12.2, 15.0]
    fit = bench_sparse_sweep.linear_fit(xs, ys)
    a = np.polyfit(xs, ys, 1)
    assert (fit["fixed_us"], fit["fdl_us_at_dense"]) == (float(a[1]), float(a[0]))
    assert fit["max_fit_residual_us"] == pytest.approx(float(np.max(np.abs(np.polyval(a, xs) - ys))))


# ----------------------------------------------------------------- grid


def test_grid_row_matches_neojax_four_step_route():
    """Block 4096, 2 channels, 4 blocks, L = 2^13 (P = 2): the port's
    cuFFT-and-B1 route against neojax's four-step route on the CPU."""
    length, c, nb = 1 << 13, 2, 4
    p = bench_grid.partitions_of(length)
    assert p == 2 and [bench_grid.partitions_of(n) for n in bench_grid.FILTERS] == [1, 1, 2, 4, 8, 16, 32]
    parts = bench_grid.random_parts(np.random.default_rng(0), p)
    sig = np.random.default_rng(1).uniform(-1, 1, (c, nb * bench_grid.BLOCK)).astype(np.float32)
    cfg, params, state, got = bench_grid.process_row("split", parts, torch.from_numpy(sig))
    assert state["fdl"].shape == (2, p, c, bench_grid.BLOCK)  # the packed ring
    jcfg = jcv.PartitionedConfig(bench_grid.BLOCK, p, c, storage="split", mac_backend="xla")
    assert jcv._use_fourstep_stream(jcfg)
    want = _jax_process(dict(block_size=bench_grid.BLOCK, num_partitions=p, channels=c, storage="split"), parts,
                        None, sig)
    assert _rel(got.numpy(), want) < _SPLIT_TOL
    assert bench_grid.hold_b1(cfg, params, state) < bench_grid.TOL["split"]


# -------------------------------------------------------------- quality


_QS = dict(channels=2, ir_seconds=0.1, sig_seconds=0.3)


def test_quality_sweep_matches_neojax():
    thresholds = [-20.0, -60.0]
    got = bench_quality_sweep.sweep(CPU, thresholds, block=256, **_QS)
    sig, ir = bench_quality_sweep.inputs(**_QS)
    want = jquality.sparse_quality_sweep(sig, ir, sample_rate=bench_quality_sweep.SR, block_size=256,
                                         thresholds_db=thresholds)
    assert [g["threshold_db"] for g in got] == [w.threshold_db for w in want] == thresholds
    for g, w in zip(got, want):
        assert g["density"] == w.density
        assert abs(g["rmse"] - w.rmse) <= _SPLIT_TOL * max(1.0, w.rmse), (g, w)
    full_sig, full_ir = bench_quality_sweep.inputs()
    assert full_sig.shape == (2, 192000) and full_ir.shape == (2, 96000)


def test_quality_sweep_main_on_the_cpu(tmp_path, capsys):
    """``--device cpu`` runs without a card and prints one JSON line."""
    import json

    out = tmp_path / "q.json"
    rc = bench_quality_sweep.main(["--device", "cpu", "--smoke", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    res = json.loads(lines[0])
    assert res == json.loads(out.read_text()) and res["card"] is None and res["device"] == CPU
    assert [p["threshold_db"] for p in res["points"]] == bench_quality_sweep.SMOKE_THRESHOLDS


# ---------------------------------------------------------- time-sharded


def test_timesharded_efficiency_model():
    eff = bench_timesharded.efficiency_model(10e-6, 2e-3, 960)
    assert list(eff) == ["960", "1920", "3840", "15360", "61440"]
    for m, v in eff.items():
        assert v == pytest.approx(int(m) * 10e-6 / (int(m) * 10e-6 + 2e-3))
    assert list(eff.values()) == sorted(eff.values())


def test_timesharded_world_of_one_equals_process():
    """The tool's world-size-1 check on gloo and the CPU: the stream
    sharded over one rank equals one ``process`` call bit for bit; the
    process group it started is gone afterwards."""
    import torch.distributed as tdd

    cfg, params, sig, halo = bench_timesharded.setup(CPU, p=6, channels=2, block=32, nb=8, storage="split")
    assert sig.shape == (2, 8 * 32) and halo.shape == (2, 6 * 32)
    res = bench_timesharded.timesharded_vs_process(cfg, params, sig, backend="gloo")
    assert not tdd.is_initialized()
    assert res["world"] == 1 and res["backend"] == "gloo" and res["blocks"] == 8
    assert res["bit_equal_vs_process"], res
    state = bench_timesharded.insert_loop(cfg, tcv.init_state(cfg, CPU), sig)
    assert state["pos"] == 8 % 6


# ------------------------------------------------------- no card, example


@pytest.mark.parametrize("tool", [int8_sweep, bench_sparse_sweep, bench_perceptual, bench_grid, bench_timesharded,
                                  bench_quality_sweep])
def test_tools_raise_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tool.main(["--smoke"])


def test_perceptual_example_run_matches_neojax():
    """``examples/perceptual_convolution_torch.run`` at a small size against
    ``neojax.bench.sparse_quality_sweep`` on the same inputs."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        example = importlib.import_module("perceptual_convolution_torch")
    finally:
        sys.path.pop(0)
    sig, ir, sr = example.synthesize(seconds=0.5, ir_seconds=0.25)
    full = example.synthesize()
    assert full[0].shape == (2, 96000) and full[1].shape == (1, 48000)
    res = example.run(sig, ir, sr, block=512, thresholds_db=(-20, -60), device=CPU)
    want = jquality.sparse_quality_sweep(sig, ir, sample_rate=float(sr), block_size=512, stft_size=1024,
                                         thresholds_db=[-20, -60])
    assert [p["threshold_db"] for p in res["points"]] == [-20.0, -60.0] and res["seconds"] > 0
    for g, w in zip(res["points"], want):
        assert g["density"] == w.density
        assert abs(g["rmse"] - w.rmse) <= _SPLIT_TOL * max(1.0, w.rmse)
    with pytest.raises(SystemExit):
        example.main(["--device", CPU, "only_one.wav"])
