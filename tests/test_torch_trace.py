"""neojax_torch.trace on the CPU: the spans' totals, their gate on the
profiler, where the program opens them, and that they change no output.

- With no profiler running, ``span`` returns one shared object a name and
  constructs no ``record_function``, and still counts calls and host time.
- Under ``torch.profiler`` the spans are ``user_annotation`` events of the
  Chrome trace, nested as the calls are: ``process`` on the fused split
  route, a masked ``filter`` and the channel binding, and ``__call__``
  through the re-blocking FIFO.
- Self time is duration less the children's, on a hand-made nesting with a
  fake clock; threads keep their own stacks and lose no update.
- Outputs are bit-equal with the profiler on and off.
"""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch

from neojax_torch import kernels, trace
from neojax_torch.conv import Convolver

B, P, C = 32, 4, 2


def _parts(seed=0, p=P):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((1, p, B + 1)) + 1j * rng.standard_normal((1, p, B + 1))) * 0.1
            ).astype(np.complex64)


def _signal(blocks, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((C, blocks * B)).astype(np.float32))


def _convolver(mask=None):
    conv = Convolver("upols", "split", sparsity=mask, device="cpu")
    conv.filter(_parts())
    return conv


def _spans(tmp_path, fn):
    """The ``user_annotation`` events (name, start µs, end µs) of a
    profiled call of ``fn``, in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, spans)
    return found[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _calls(name):
    return trace.totals().get(name, {"calls": 0})["calls"]


def test_span_without_profiler_is_shared_and_counts(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function constructed with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("test.shared") is trace.span("test.shared")
    before = trace.totals().get("test.shared", {"calls": 0, "host_s": 0.0})
    for _ in range(3):
        with trace.span("test.shared"):
            sum(range(1000))
    after = trace.totals()["test.shared"]
    assert after["calls"] == before["calls"] + 3
    assert after["host_s"] > before["host_s"] and after["self_s"] > 0.0
    # the program's own spans go the same way: a whole process call
    conv = _convolver()
    n = _calls("conv.process")
    conv.process(_signal(4))
    assert _calls("conv.process") == n + 1


def test_span_under_profiler_is_a_record_function(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    s = trace.span("test.recorded")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with s:
            pass
    with s:  # the profiler has stopped
        pass
    assert made == ["test.recorded"] and s is trace.span("test.recorded")


def test_process_spans_nest(tmp_path):
    conv = _convolver()
    conv.process(_signal(2))  # binds the channels
    spans = _spans(tmp_path, lambda: conv.process(_signal(6)))
    assert [s[0] for s in spans] == ["conv.process", "conv.dcfix", "kernels.fused_stream"]
    proc, fix, stream = spans
    assert _inside(fix, proc) and _inside(stream, proc) and fix[2] <= stream[1]


def test_masked_filter_and_bind_spans(tmp_path):
    rng = np.random.default_rng(3)
    mask = rng.random((1, P, B + 1)) < 0.4
    mask[..., :2] = True
    conv = Convolver("upols", "split", sparsity=mask, require_sparsity=True, device="cpu")
    spans = _spans(tmp_path, lambda: conv.filter(_parts()))
    assert [s[0] for s in spans] == ["conv.filter"]
    assert "sp_c_idx" in conv.params  # the masked schedules were built in it
    first = _spans(tmp_path, lambda: conv.process(_signal(3)))  # 2 channels against a mono filter
    proc, bind = _one(first, "conv.process"), _one(first, "conv.bind")
    assert _inside(bind, proc) and conv.config.channels == C
    later = _spans(tmp_path, lambda: conv.process(_signal(3, seed=2)))
    assert not [s for s in later if s[0] in ("conv.bind", "conv.filter")]
    _one(later, "conv.process")


def test_call_spans_nest_through_the_fifo(tmp_path):
    conv = _convolver()
    x = _signal(3)
    conv(x[:, :B])  # binds the channels
    spans = _spans(tmp_path, lambda: conv(x[:, B : 2 * B + B // 2]))  # not a whole block: the FIFO
    assert [s[0] for s in spans] == ["conv.call", "conv.fifo", "conv.step", "conv.dcny", "kernels.block_step"]
    call, fifo, step, dcny, block = spans
    assert _inside(fifo, call) and _inside(step, fifo)
    assert _inside(dcny, step) and _inside(block, step) and dcny[2] <= block[1]


def test_self_time_is_duration_less_children(monkeypatch):
    ticks = iter([0, 10, 30, 40, 50, 55, 70, 100])
    monkeypatch.setattr(trace, "_clock", lambda: next(ticks))
    names = ["test.outer", "test.a", "test.b", "test.c"]
    before = {n: trace.totals().get(n, {"calls": 0, "host_s": 0.0, "self_s": 0.0}) for n in names}
    with trace.span("test.outer"):  # 0 .. 100
        with trace.span("test.a"):  # 10 .. 30
            pass
        with trace.span("test.b"):  # 40 .. 70
            with trace.span("test.c"):  # 50 .. 55
                pass
    after = trace.totals()
    want = {"test.outer": (100, 50), "test.a": (20, 20), "test.b": (30, 25), "test.c": (5, 5)}
    for n, (host, self_) in want.items():
        assert after[n]["calls"] == before[n]["calls"] + 1
        assert after[n]["host_s"] - before[n]["host_s"] == pytest.approx(host * 1e-9)
        assert after[n]["self_s"] - before[n]["self_s"] == pytest.approx(self_ * 1e-9)


def test_threads_keep_their_own_stacks():
    workers, rounds = 16, 2000
    before = {n: _calls(n) for n in ("test.thread", "test.thread.inner")}
    errors = []

    def work():
        try:
            for _ in range(rounds):
                with trace.span("test.thread"):
                    with trace.span("test.thread.inner"):
                        pass
        except Exception as e:  # reported below: a thread's failure must fail the test
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    t = trace.totals()
    assert t["test.thread"]["calls"] == before["test.thread"] + workers * rounds
    assert t["test.thread.inner"]["calls"] == before["test.thread.inner"] + workers * rounds
    assert t["test.thread"]["self_s"] < t["test.thread"]["host_s"]


def test_snapshot_reads_the_launch_counters_and_reset_clears_spans():
    with trace.span("test.snapshot"):
        pass
    snap = trace.snapshot()
    assert snap["launches"] == kernels.launch_counts()
    assert snap["spans"]["test.snapshot"]["calls"] >= 1
    trace.reset()
    assert trace.totals() == {}


def test_outputs_bit_equal_with_the_profiler_on_and_off():
    def run(profiled):
        conv = _convolver()
        x = _signal(9)
        with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
              else contextlib.nullcontext()):
            y = [conv.process(x[:, : 4 * B]), conv(x[:, 4 * B : 5 * B]), conv(x[:, 5 * B : 6 * B + 5]),
                 conv(x[:, 6 * B + 5 :])]
        return y

    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)
