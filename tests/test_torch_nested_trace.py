"""The nested engine's spans on the CPU: ``make_engine("nested",
storage="int8")`` opens ``nested.process`` around each call and, in each
chunk, ``nested.forward``, ``nested.push``, B5's ``kernels.nested_mac`` and
``nested.inverse``, each a child of ``nested.process``; the spans change no
output; and the int8 engine stays within the benchmark configuration's
limits against the float64 reference (``benchmark/reference/upols.py``).
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import upols
from neojax_torch import trace
from neojax_torch.conv import make_engine
from neojax_torch.conv import nested as nested_lib
from neojax_torch.kernels import nested_mac as nested_mac_lib

B, P, C, S = 64, 30, 2, 8  # the benchmark configuration's small sizes
STAGES = ("nested.forward", "nested.push", "kernels.nested_mac", "nested.inverse")
CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "ambi64_10s_int8.json"
LIMITS = json.loads(CONFIG.read_text())["limits"]


def _ir(seed=0):
    rng = np.random.default_rng(seed)
    taps = P * B
    return (rng.standard_normal(taps) * np.exp(-np.arange(taps) / (0.3 * taps)) * 0.1).astype(np.float32)


def _engine():
    spectra = upols.partition(_ir(), B)
    return make_engine("nested", spectra[None], block_size=B, storage="int8", chunk_blocks=S, channels=C,
                       device="cpu"), spectra


def _signal(blocks, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-0.3, 0.3, (C, blocks * B)).astype(np.float32))


def _calls():
    totals = trace.totals()
    return {n: totals.get(n, {"calls": 0})["calls"] for n in ("nested.process",) + STAGES}


def test_each_call_opens_one_process_span_and_four_a_chunk():
    eng, _ = _engine()
    for chunks in (3, 1, 2):
        before = _calls()
        eng.process(_signal(chunks * S, seed=chunks))
        got = {n: c - before[n] for n, c in _calls().items()}
        assert got == {"nested.process": 1, **{n: chunks for n in STAGES}}


def test_the_stages_are_children_of_the_process_span():
    """``nested.process``'s self time is its host time less exactly the four
    stages': each is its direct child, and none holds another."""
    eng, _ = _engine()
    eng.process(_signal(S))
    trace.reset()
    eng.process(_signal(4 * S, seed=2))
    totals = trace.totals()
    children = sum(totals[n]["host_s"] for n in STAGES)
    proc = totals["nested.process"]
    assert proc["self_s"] == pytest.approx(proc["host_s"] - children, abs=1e-8)
    for n in STAGES:
        assert totals[n]["self_s"] == pytest.approx(totals[n]["host_s"], abs=1e-8)


def test_under_the_profiler_the_spans_nest_in_order(tmp_path):
    eng, _ = _engine()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.process(_signal(2 * S))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation" and e.get("ph") == "X"), key=lambda s: (s[1], -s[2]))
    assert [s[0] for s in spans] == ["nested.process"] + list(STAGES) * 2
    (_, a, b), stages = spans[0], spans[1:]
    assert all(a <= s <= e <= b for _, s, e in stages)
    assert all(x[2] <= y[1] for x, y in zip(stages, stages[1:]))  # one after another


def _no_spans(monkeypatch):
    fake = type("NoTrace", (), {"span": staticmethod(lambda name: contextlib.nullcontext())})
    monkeypatch.setattr(nested_lib, "trace", fake)
    monkeypatch.setattr(nested_mac_lib, "trace", fake)


def test_the_spans_change_no_output(monkeypatch):
    """Bit-equal over three calls: with the spans, with the trace reset
    between calls and the profiler on for one, and with no spans at all."""
    inputs = [_signal(2 * S, seed=10 + i) for i in range(3)]
    eng, _ = _engine()
    with_spans = [eng.process(x) for x in inputs]
    eng, _ = _engine()
    reset = []
    for i, x in enumerate(inputs):
        trace.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if i == 1 \
                else contextlib.nullcontext():
            reset.append(eng.process(x))
    _no_spans(monkeypatch)
    eng, _ = _engine()
    without = [eng.process(x) for x in inputs]
    for a, b, c in zip(with_spans, reset, without):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_the_int8_engine_is_within_the_configurations_limits_of_the_reference():
    """Four calls of 2 chunks (64 blocks, twice around the 32-partition
    meta ring) on a seeded stream; blocks early and late held against the
    float64 reference."""
    eng, spectra = _engine()
    x = torch.cat([_signal(2 * S, seed=20 + i) for i in range(4)], dim=-1)
    out = torch.cat([eng.process(x[:, i * 2 * S * B : (i + 1) * 2 * S * B]) for i in range(4)], dim=-1)

    def segment(g0, g1):
        pad = max(0, -g0) * B
        return torch.nn.functional.pad(x[:, max(0, g0) * B : g1 * B], (pad, 0))

    blocks = [0, 5, 17, 31, 32, 40, 47, 63]
    refs = upols.output_blocks(segment, spectra, blocks, B)
    num = den = worst = 0.0
    for g, ref in refs.items():
        d = out[:, g * B : (g + 1) * B].double() - ref
        num, den = num + float((d * d).sum()), den + float((ref * ref).sum())
        worst = max(worst, float(d.abs().max()))
    rms = (den / (len(blocks) * C * B)) ** 0.5
    assert (num / den) ** 0.5 <= LIMITS["rel_rms_err"]
    assert worst / rms <= LIMITS["max_err_over_rms"]
