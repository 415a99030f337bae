"""neojax_torch's entry points run on the card unless the caller asks for the
CPU: with no ``device`` and no card they raise a RuntimeError that names
``device="cpu"`` (never a silent CPU run), with a card they pick ``cuda``,
and the ``*_init_state`` functions of the nested, hybrid and chunked
engines follow their params' device (the chunked engine's resolves
``device`` like the others when its params hold no tensor: a fully masked
filter).

The distributed entry points follow the same rule: ``make_mesh`` and the
engines built on its mesh (``sharded_process``, ``weak_scaling_sweep``)
put each rank on the card unless given ``device="cpu"``. The streaming
engines take a numpy signal onto their state's device and refuse a tensor
that lies on another device (naming both) rather than copy it.

Whether a card is visible is set per test with ``monkeypatch`` on
``torch.cuda.is_available``, so these tests mean the same on any machine.
"""

import numpy as np
import pytest
import torch

import neojax_torch
from neojax_torch import cli as tcli
from neojax_torch import core as tcore
from neojax_torch import fft as tfft
from neojax_torch import ops as tops
from neojax_torch import conv as tconv
from neojax_torch import convert
from neojax_torch import dist as tdist
from neojax_torch.bench import quality, scaling
from neojax_torch.conv import chunked as tch
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import hybrid as thy
from neojax_torch.conv import nested as tnested
from neojax_torch.conv.streaming import streaming_convolve
from neojax_torch.dist import partnested as tpn
from neojax_torch.fft import matmul_backend as tmb
from neojax_torch.core.device import resolve_device

B, P, C = 16, 4, 2

_CONVOLVERS = {
    "Convolver": lambda **kw: tconv.Convolver(**kw),
    "make_convolver": lambda **kw: tconv.make_convolver("upola", "split", **kw),
    "upols_convolver": tconv.upols_convolver,
    "upola_convolver": tconv.upola_convolver,
    "upola_convolver_v2": tconv.upola_convolver_v2,
    "split_upols_convolver": tconv.split_upols_convolver,
    "split_upola_convolver": tconv.split_upola_convolver,
    "sparse_upols_convolver": tconv.sparse_upols_convolver,
    "sparse_upola_convolver": tconv.sparse_upola_convolver,
}


def _parts():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((1, P, B + 1)) + 1j * rng.standard_normal((1, P, B + 1))).astype(np.complex64)


def _cfg():
    return tcv.PartitionedConfig(B, P, C, storage="split")


def _numpy(tree):
    """The port's params or state as numpy arrays, in the layout the
    ``*_from_neojax`` functions take (nested dicts kept)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return convert.state_to_numpy({"x": tree})["x"]


def _cpu_params(build):
    return _numpy(build(_cfg(), _parts(), *([] if build is tcv.filter_params else [2]), device="cpu"))


_FUNCTIONS = {
    "filter_params": lambda **kw: tcv.filter_params(_cfg(), _parts(), **kw),
    "init_state": lambda **kw: tcv.init_state(_cfg(), **kw),
    "nested_filter_params": lambda **kw: tnested.nested_filter_params(_cfg(), _parts(), 2, **kw),
    "hybrid_filter_params": lambda **kw: thy.hybrid_filter_params(_cfg(), _parts(), 2, **kw),
    "sparse_quality_sweep": lambda **kw: quality.sparse_quality_sweep(
        np.zeros((1, 64), np.float32), np.ones(32, np.float32), sample_rate=48000.0,
        block_size=16, stft_size=16, thresholds_db=[-20.0], **kw),
    "params_from_neojax": lambda **kw: convert.params_from_neojax(
        _cfg(), _cpu_params(tcv.filter_params), **kw),
    "state_from_neojax": lambda **kw: convert.state_from_neojax(
        _cfg(), convert.state_to_numpy(tcv.init_state(_cfg(), device="cpu")), **kw),
    "nested_params_from_neojax": lambda **kw: convert.nested_params_from_neojax(
        _cfg(), _cpu_params(tnested.nested_filter_params), **kw),
    "nested_state_from_neojax": lambda **kw: convert.nested_state_from_neojax(
        _cfg(), convert.state_to_numpy(tnested.nested_init_state(
            _cfg(), tnested.nested_filter_params(_cfg(), _parts(), 2, device="cpu"))), **kw),
    "hybrid_params_from_neojax": lambda **kw: convert.hybrid_params_from_neojax(
        _cfg(), _cpu_params(thy.hybrid_filter_params), **kw),
    "hybrid_state_from_neojax": lambda **kw: convert.hybrid_state_from_neojax(
        _cfg(), convert.state_to_numpy(thy.hybrid_init_state(
            _cfg(), thy.hybrid_filter_params(_cfg(), _parts(), 2, device="cpu"))), **kw),
    "chunked_filter_params": lambda **kw: tch.chunked_filter_params(_cfg(), _parts(), 2, **kw),
    "partnested_filter_params": lambda **kw: tpn.partnested_filter_params(_cfg(), _parts(), 2, 1, **kw),
    # a fully masked filter: no bucket, so no params tensor to follow
    "chunked_init_state": lambda **kw: tch.chunked_init_state(_cfg(), {"buckets": ()}, **kw),
    "chunked_params_from_neojax": lambda **kw: convert.chunked_params_from_neojax(
        _cfg(), _chunked_np(tch.chunked_filter_params(_cfg(), _parts(), 2, device="cpu")), **kw),
    "chunked_state_from_neojax": lambda **kw: convert.chunked_state_from_neojax(
        _cfg(), convert.state_to_numpy(tch.chunked_init_state(
            _cfg(), tch.chunked_filter_params(_cfg(), _parts(), 2, device="cpu"))), **kw),
    "make_engine": lambda **kw: tconv.make_engine("chunked", _parts(), chunk_blocks=2, channels=C, **kw),
    "convolve": lambda **kw: neojax_torch.convolve(np.ones(8, np.float32), np.ones(3, np.float32), **kw),
    "direct_convolve": lambda **kw: tconv.direct_convolve(np.ones(8, np.float32), np.ones(3, np.float32), **kw),
    "fft_convolve": lambda **kw: tconv.fft_convolve(np.ones(8, np.float32), np.ones(3, np.float32), **kw),
    "OverlapSave.init_state": lambda **kw: tconv.OverlapSave(B, 5).init_state(C, **kw),
    "OverlapAdd.init_state": lambda **kw: tconv.OverlapAdd(B, 5).init_state(C, **kw),
    "rfft_matrices": lambda **kw: tmb.rfft_matrices(B, **kw),
    "irfft_matrices": lambda **kw: tmb.irfft_matrices(B, **kw),
    "fft_matrices": lambda **kw: tmb.fft_matrices(B, **kw),
    # the surface of fft/core/ops: host input goes to the card by default
    "stft": lambda **kw: tfft.stft(np.ones(64, np.float32), 16, **kw),
    "rectangular_window": lambda **kw: tcore.rectangular_window(8, **kw),
    "hann_window": lambda **kw: tcore.hann_window(8, **kw),
    "hamming_window": lambda **kw: tcore.hamming_window(8, **kw),
    "make_window": lambda **kw: tcore.make_window(np.ones(8), 8, **kw),
    "dft": lambda **kw: tfft.dft(np.ones(5, np.complex64), **kw),
    "naive_dft": lambda **kw: tfft.naive_dft(np.ones(5, np.complex64), **kw),
    "dct2": lambda **kw: tfft.dct2(np.ones(8, np.float32), **kw),
    "split_fft": lambda **kw: tfft.split_fft(np.ones(8, np.float32), np.zeros(8, np.float32), **kw),
    "packed_rfft": lambda **kw: tfft.packed_rfft(np.ones(8, np.float32), **kw),
    "rfft_deinterleave": lambda **kw: tfft.rfft_deinterleave(np.ones(8, np.float32), np.ones(8, np.float32), **kw),
    "to_split": lambda **kw: tcore.to_split(np.ones(4, np.complex64), **kw),
    "to_fixed": lambda **kw: tcore.fixed_point.to_fixed(np.ones(4) * 0.5, **kw),
    "quantize_fixed": lambda **kw: tops.quantize_fixed(np.ones(4, np.float32), torch.int8, **kw),
    "normalize_peak": lambda **kw: tops.normalize_peak(np.ones(4, np.float32), **kw),
    "variance": lambda **kw: tops.variance(np.ones(4, np.float32), **kw),
    "allclose": lambda **kw: tops.allclose(np.ones(4, np.float32), np.ones(4, np.float32), **kw),
}


def _chunked_np(params):
    """Chunked params as numpy, the layout ``chunked_params_from_neojax`` takes."""
    return {"buckets": tuple({k: v if isinstance(v, int) else v.numpy() for k, v in bk.items()}
                             for bk in params["buckets"])}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("name", sorted(_CONVOLVERS) + sorted(_FUNCTIONS))
def test_no_device_without_a_card_raises(no_card, name):
    make = _CONVOLVERS.get(name) or _FUNCTIONS[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


@pytest.mark.parametrize("name", sorted(_CONVOLVERS) + sorted(_FUNCTIONS))
def test_cpu_on_request_runs(no_card, name):
    make = _CONVOLVERS.get(name) or _FUNCTIONS[name]
    out = make(device="cpu")
    if isinstance(out, tconv.Convolver):
        assert out.device == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(_CONVOLVERS))
def test_convolvers_default_to_the_card(card, name):
    c = _CONVOLVERS[name]()
    assert c.device == torch.device("cuda")
    if name in ("Convolver", "upols_convolver", "upola_convolver", "sparse_upols_convolver"):
        assert c._storage == "split"  # the storage default follows the resolved device


@pytest.mark.parametrize("name", sorted(set(_FUNCTIONS) - {"sparse_quality_sweep"}))
def test_functions_default_to_the_card(card, name):
    """With a card visible (faked here), no ``device`` sends the tensors to
    ``cuda``: this CPU build of torch then refuses the move itself, which
    shows the entry point did not stay on the CPU."""
    with pytest.raises((AssertionError, RuntimeError)) as err:
        _FUNCTIONS[name]()
    assert 'device="cpu"' not in str(err.value) and "CUDA" in str(err.value)


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


_CONVOLVE = {
    "convolve": neojax_torch.convolve,
    "direct_convolve": tconv.direct_convolve,
    "fft_convolve": tconv.fft_convolve,
    "streaming_convolve": lambda a, h: streaming_convolve(a, h, "ols"),
}


@pytest.mark.parametrize("name", sorted(_CONVOLVE))
def test_convolve_surface_keeps_tensors_where_they_lie(no_card, name):
    """The array functions' one input rule (``core.device.as_tensor``): with
    no ``device`` a tensor input is used where it lies, so CPU tensors run
    on the CPU with no card; host input goes to the card and raises."""
    a, h = torch.ones(8), torch.ones(3)
    out = _CONVOLVE[name](a, h)
    assert out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), np.convolve(np.ones(8), np.ones(3)), atol=1e-5)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _CONVOLVE[name](a.numpy(), h.numpy())


def test_engine_init_states_follow_their_params(no_card):
    cfg = _cfg()
    nparams = tnested.nested_filter_params(cfg, _parts(), 2, device="cpu")
    hparams = thy.hybrid_filter_params(cfg, _parts(), 2, device="cpu")
    assert tnested.nested_init_state(cfg, nparams)["tail"].device.type == "cpu"
    assert thy.hybrid_init_state(cfg, hparams)["btail"].device.type == "cpu"
    assert thy.HybridStream(cfg, hparams).device.type == "cpu"
    cparams = tch.chunked_filter_params(cfg, _parts(), 2, device="cpu")
    assert tch.chunked_init_state(cfg, cparams)["hists"][0].device.type == "cpu"


def test_engine_storage_follows_the_device(no_card):
    """``make_engine``'s ``storage=None`` is the convolver's rule: dense on
    the CPU (the card's ``"split"`` is checked on the card)."""
    for engine in ("perblock", "nested", "hybrid", "chunked"):
        eng = tconv.make_engine(engine, _parts(), chunk_blocks=2, channels=C, device="cpu")
        assert eng.config.storage == "dense" and eng.device == torch.device("cpu")


def _cli_files(tmp_path):
    from neojax_torch.io.wav import write_wav

    write_wav(str(tmp_path / "s.wav"), np.ones((1, 64), np.float32) * 0.1, 8000, bits=32)
    write_wav(str(tmp_path / "i.wav"), np.ones((1, 16), np.float32) * 0.1, 8000, bits=32)
    return [str(tmp_path / "s.wav"), str(tmp_path / "i.wav"), str(tmp_path / "o.wav"), "--block", "16"]


def test_cli_without_a_card_raises(no_card, tmp_path):
    """``--device`` defaults to ``cuda``: with no card the CLI raises the
    RuntimeError naming ``device="cpu"``, before it reads a file."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(_cli_files(tmp_path))


def test_cli_cpu_on_request_runs(no_card, tmp_path):
    assert tcli.main(_cli_files(tmp_path) + ["--device", "cpu"]) == 0


def test_cli_defaults_to_the_card(card, tmp_path):
    with pytest.raises((AssertionError, RuntimeError)) as err:
        tcli.main(_cli_files(tmp_path))
    assert 'device="cpu"' not in str(err.value) and "CUDA" in str(err.value)


def test_stft_and_windows_keep_tensors_where_they_lie(no_card):
    """P2: a tensor is transformed where it lies; the window follows it."""
    out = tfft.stft(torch.ones(64), 16)
    assert out.device.type == "cpu" and out.shape == (1, 8, 9)
    assert tfft.dct2(torch.ones(8)).device.type == "cpu"


# ------------------------------------------------ the distributed entry points

_DIST = {
    "make_mesh": lambda **kw: tdist.make_mesh(**kw),
    "Mesh": lambda **kw: tdist.Mesh(("time",), (1,), **kw),
    "sharded_process": lambda **kw: tdist.sharded_process(
        _cfg(), tcv.filter_params(_cfg(), _parts(), device="cpu"), tcv.init_state(_cfg(), "cpu"),
        np.ones((C, 2 * B), np.float32), tdist.make_mesh(**kw)),
    "weak_scaling_sweep": lambda **kw: scaling.weak_scaling_sweep(
        channels_per_device=1, block_size=B, num_partitions=P, chunk_blocks=2, seconds=0.002,
        storage="split", **kw),
}


@pytest.mark.parametrize("name", sorted(_DIST))
def test_dist_without_a_card_raises(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _DIST[name]()


@pytest.mark.parametrize("name", sorted(_DIST))
def test_dist_cpu_on_request_runs(no_card, name):
    _DIST[name](device="cpu")


def _engine_run(engine, signal):
    cfg = _cfg()
    if engine == "process":
        params = tcv.filter_params(cfg, _parts(), device="cpu")
        return tcv.process(cfg, params, tcv.init_state(cfg, "cpu"), signal)[1]
    if engine == "process_nested":
        params = tnested.nested_filter_params(cfg, _parts(), 2, device="cpu")
        return tnested.process_nested(cfg, params, tnested.nested_init_state(cfg, params), signal)[1]
    params = thy.hybrid_filter_params(cfg, _parts(), 2, device="cpu")
    return thy.process_hybrid(cfg, params, thy.hybrid_init_state(cfg, params), signal)[1]


_ENGINES = ["process", "process_nested", "process_hybrid"]


@pytest.mark.parametrize("engine", _ENGINES)
def test_engines_take_a_numpy_signal(no_card, engine):
    """A host (numpy) signal goes to the state's device and gives what the
    tensor gives there."""
    sig = np.random.default_rng(3).uniform(-1, 1, (C, 4 * B)).astype(np.float32)
    out = _engine_run(engine, sig)
    assert out.device.type == "cpu"
    assert torch.equal(out, _engine_run(engine, torch.from_numpy(sig)))


@pytest.mark.parametrize("engine", _ENGINES)
def test_engines_refuse_a_signal_on_another_device(no_card, engine):
    with pytest.raises(ValueError, match="meta.*cpu"):
        _engine_run(engine, torch.zeros((C, 4 * B), device="meta"))
