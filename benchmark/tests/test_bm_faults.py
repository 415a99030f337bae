"""Faults planted underneath the timed path (in the engine functions that
``Convolver`` calls) must make ``correct`` come out false: a step that
returns its state unchanged, half of the channels left out with the mean
of the rest in their place, and an answer altered where it is produced.
(One chip, so no exchange between chips can be left out.)"""

import pytest
import torch

from benchmark.lib import spec
from benchmark.tests import tiny
from neojax_torch.conv import convolver as cv


def _clone(state):
    return {k: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                else v.clone() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}


def state_unchanged(real):
    def fn(config, params, state, x):
        _, out = real(config, params, _clone(state), x)
        return state, out
    return fn


def half_left_out(real):
    def fn(config, params, state, x):
        state, out = real(config, params, state, x)
        out = out.clone()
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(dim=0, keepdim=True)
        return state, out
    return fn


def answer_altered(real):
    def fn(config, params, state, x):
        state, out = real(config, params, state, x)
        out = out.clone()
        out[0, :: config.block_size] *= -1.0
        return state, out
    return fn


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("mix", tiny.MIXES)
def test_fault_is_caught(mix, fault, device, monkeypatch):
    name = "process" if spec.cell_for(*mix)["traffic"]["entry"] == "process" else "step"
    monkeypatch.setattr(cv, name, fault(getattr(cv, name)))
    res = tiny.run(mix, 2**31 + 99, device)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_sound_run_is_correct(mix, device):
    res = tiny.run(mix, 2**31 + 99, device)
    assert res["correct"] is True, res["checks"]
