"""neojax_torch's entry points run on the card unless the caller asks for the
CPU: with no ``device`` and no card they raise a RuntimeError that names
``device="cpu"`` (never a silent CPU run), with a card they pick ``cuda``,
and the ``*_init_state`` functions of the nested and hybrid engines follow
their params' device.

Whether a card is visible is set per test with ``monkeypatch`` on
``torch.cuda.is_available``, so these tests mean the same on any machine.
"""

import numpy as np
import pytest
import torch

from neojax_torch import conv as tconv
from neojax_torch import convert
from neojax_torch.bench import quality
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import hybrid as thy
from neojax_torch.conv import nested as tnested
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
}


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


def test_engine_init_states_follow_their_params(no_card):
    cfg = _cfg()
    nparams = tnested.nested_filter_params(cfg, _parts(), 2, device="cpu")
    hparams = thy.hybrid_filter_params(cfg, _parts(), 2, device="cpu")
    assert tnested.nested_init_state(cfg, nparams)["tail"].device.type == "cpu"
    assert thy.hybrid_init_state(cfg, hparams)["btail"].device.type == "cpu"
    assert thy.HybridStream(cfg, hparams).device.type == "cpu"
