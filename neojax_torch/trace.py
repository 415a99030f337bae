"""Spans and counters of the program.

``span(name)`` marks a stretch of host work at a layer boundary::

    with trace.span("conv.process"):
        ...

Every span, always, adds one call, its host nanoseconds
(``time.perf_counter_ns``) and its self time (its duration less the part
its child spans cover) to the totals of its name; each thread keeps its
own stack of open spans. ``span`` returns one shared object a name. Entered
while the torch profiler records (the flag ``torch.autograd.profiler`` sets
while a profiler runs), a span also enters
``torch.profiler.record_function(name)``, so it lands in the profiler's
trace on the device's clock, beside the kernels launched inside it. With
the profiler off no ``record_function`` is constructed, and a span costs
two clock reads and a few additions.

``totals()`` reads the span totals, ``snapshot()`` them, the kernel
wrappers' launch counters (``kernels.launch_counts()``) and the kernels'
work counters (``kernels.counters()``), ``reset()`` clears the span totals
(``kernels.reset_launch_counts()`` the counters). A Chrome
trace with the spans in it is written by ``bench.profile.trace``.

The spans (name: what it covers):

- ``conv.filter``: ``Convolver.filter`` (host packing, upload, a mask's
  schedules);
- ``conv.bind``: ``Convolver._bind_channels`` when it rebuilds the state
  (and a mask's schedules) for a new channel count;
- ``conv.process``: ``Convolver.process``;
- ``conv.dcfix``: the float64 DC/Nyquist side-carry of a whole stream
  (``conv.convolver._dcfix_sequence``);
- ``kernels.fused_stream``: B3's wrapper (checks, staging, launches);
- ``conv.call``: ``Convolver.__call__``;
- ``conv.fifo``: its re-blocking FIFO;
- ``conv.step``: one block (``conv.convolver.step``);
- ``conv.dcny``: the DC/Nyquist side-carry of one fused block;
- ``kernels.block_step``: B2's wrapper (workspace and its one C call);
- ``nested.process``: ``conv.nested.process_nested``, the nested engine's
  call (and so ``make_engine("nested")``'s ``process``);
- ``nested.forward``: a chunk's frames, block rfft, meta window's cats and
  meta-FFT;
- ``nested.push``: a chunk's ``kernels.meta_push`` (the int storages' group
  peak, rounding and clamp; the ring and scale writes), one launch on the
  card, counted in ``meta_push.launches``;
- ``kernels.nested_mac``: B5's wrapper (checks, allocation, launch), in the
  nested engine and in the hybrid engine's tail;
- ``nested.inverse``: a chunk's inverse meta-FFT, block irfft, output
  slice and tail.
"""

from __future__ import annotations

import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "totals", "snapshot", "reset"]

_clock = time.perf_counter_ns
_lock = threading.Lock()
_threads: list[dict] = []  # each thread's totals (outliving the thread), read by totals()


class _Thread(threading.local):
    """A thread's open spans and totals: no lock on the span's path."""

    def __init__(self):
        self.open: list[list] = []  # [totals row, ns covered by children, start ns, record_function]
        self.totals: dict[str, list[int]] = {}  # name -> [calls, host ns, self ns]
        with _lock:
            _threads.append(self.totals)


_thread = _Thread()


class _Span:
    """Host totals of one name; holds no state of its own between enter
    and exit, so one object serves every call and thread."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        th = _thread
        row = th.totals.get(self.name)
        if row is None:
            row = th.totals[self.name] = [0, 0, 0]
        rf = None
        if _profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        th.open.append([row, 0, _clock(), rf])
        return self

    def __exit__(self, exc_type, exc, tb):
        end = _clock()
        opened = _thread.open
        row, covered, start, rf = opened.pop()
        dur = end - start
        if opened:
            opened[-1][1] += dur
        row[0] += 1
        row[1] += dur
        row[2] += dur - covered
        if rf is not None:
            rf.__exit__(exc_type, exc, tb)
        return False


class _Spans(dict):
    """The one span object of each name, made at its first use."""

    def __missing__(self, name: str) -> _Span:
        return self.setdefault(name, _Span(name))


# span(name): the context manager that times the enclosed host work under
# ``name`` (a dict lookup, so the call costs no Python frame)
span = _Spans().__getitem__


def totals() -> dict:
    """``{name: {"calls", "host_s", "self_s"}}`` of every span closed since
    the process started or :func:`reset` last ran, over all threads."""
    with _lock:
        tables = list(_threads)
    out: dict[str, dict] = {}
    for table in tables:
        for name, (c, h, s) in list(table.items()):
            o = out.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0})
            o["calls"] += c
            o["host_s"] += h * 1e-9
            o["self_s"] += s * 1e-9
    return out


def snapshot() -> dict:
    """``{"spans": totals(), "launches": kernels.launch_counts(),
    "counters": kernels.counters()}``."""
    from neojax_torch import kernels

    return {"spans": totals(), "launches": kernels.launch_counts(), "counters": kernels.counters()}


def reset() -> None:
    """Clear the span totals; a span open across the reset is not counted."""
    with _lock:
        for table in _threads:
            table.clear()
