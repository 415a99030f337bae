"""Faults planted underneath the timed path (in the engine functions that
``Convolver`` calls, and those that ``make_engine``'s engines bind) must
make ``correct`` come out false: a step that returns its state unchanged,
half of the channels left out with the mean of the rest in their place,
and an answer altered where it is produced. (One chip, so no exchange
between chips can be left out.)"""

import pytest
import torch

from benchmark.lib import spec
from benchmark.tests import tiny
from benchmark.tests.test_bm_engines import FIXTURE, INT8
from neojax_torch.conv import chunked, hybrid, nested
from neojax_torch.conv import convolver as cv

# the functional core that each engine's ``process`` runs
ENGINE_CORE = {
    "perblock": (cv, "process"),
    "nested": (nested, "process_nested"),
    "chunked": (chunked, "process_chunked"),
    "hybrid": (hybrid, "process_hybrid"),
}


def _clone(v):
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    return v.clone() if isinstance(v, torch.Tensor) else v


def state_unchanged(real):
    def fn(config, params, state, x, **kw):
        _, out = real(config, params, _clone(state), x, **kw)
        return state, out
    return fn


def half_left_out(real):
    def fn(config, params, state, x, **kw):
        state, out = real(config, params, state, x, **kw)
        out = out.clone()
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(dim=0, keepdim=True)
        return state, out
    return fn


def answer_altered(real):
    def fn(config, params, state, x, **kw):
        state, out = real(config, params, state, x, **kw)
        out = out.clone()
        out[0, :: config.block_size] *= -1.0
        return state, out
    return fn


def _core(cell: dict):
    """Where a cell's timed path runs: the Convolver's ``process`` or
    ``step`` by its traffic's entry, another engine's functional core."""
    kind = spec.engine(cell["config"])
    if kind != "convolver":
        return ENGINE_CORE[kind]
    return cv, "process" if cell["traffic"]["entry"] == "process" else "step"


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("mix", tiny.MIXES)
def test_fault_is_caught(mix, fault, device, monkeypatch):
    module, name = _core(spec.cell_for(*mix))
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res = tiny.run(mix, 2**31 + 99, device)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_sound_run_is_correct(mix, device):
    res = tiny.run(mix, 2**31 + 99, device)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("engine", sorted(ENGINE_CORE))
def test_an_engine_fault_is_caught(engine, fault, device, monkeypatch):
    module, name = ENGINE_CORE[engine]
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res = tiny.run((FIXTURE[engine], "render"), 2**31 + 99, device)
    assert res["correct"] is False and res["failed"] == 0, res["checks"]  # judged wrong, not raised


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
def test_a_fault_in_the_int8_nested_render_is_caught(fault, device, monkeypatch):
    monkeypatch.setattr(nested, "process_nested", fault(nested.process_nested))
    res = tiny.run((INT8, "render"), 2**31 + 99, device)
    assert res["correct"] is False and res["failed"] == 0, res["checks"]
