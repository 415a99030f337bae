"""The general traffic generator. A traffic mix is a data file
(``benchmark/traffic/<name>.json``); its ``loop`` picks one of two drivers:

- ``closed``: calls of ``call_blocks`` blocks to ``Convolver.process`` back
  to back on one continuing stream, each input a device chunk of the
  set-up's pool, for ``--seconds``; the window ends in a device
  synchronise. Outputs are dropped, except a reservoir sample of
  ``kept_calls`` whole calls (drawn from the seed) and the last call.
- ``open``: one ``Convolver.__call__`` per block at the audio clock
  (``block / sample_rate`` apart), each handed a pageable host block and
  bringing its output back to host memory. The driver spins to each due
  time and times a callback from it, so a late callback delays the next.

Spans (``torch.profiler.record_function``) mark the benchmark's calls into
the program in a traced run.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback

import numpy as np
import torch

from benchmark.lib import trace as trace_lib

__all__ = ["STRETCH_SPAN", "Window", "sync", "callbacks", "run_closed", "run_open"]

# the span of each call into the program in a traced stretch, by loop
STRETCH_SPAN = {"closed": "render.process", "open": "live.callback"}


def callbacks(config: dict, seconds: float) -> int:
    """Callbacks of an open-loop window of ``seconds`` at the audio clock."""
    return int(seconds * config["sample_rate"] / config["block"] + 1e-9)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """What a window did: calls attempted and failed (of which ``broken``
    raised or returned another shape; the rest were late), the host seconds
    and channel-samples processed (closed loop), latencies (open loop), host
    enqueue times (closed loop, traced runs), the outputs kept for the check
    ``{global block: [C, B] tensor}`` and the traces."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.broken = 0  # calls that raised or returned another shape: answers that never came
        self.seconds = 0.0
        self.samples = 0
        self.latencies: list[float] = []
        self.enqueue_s: list[float] = []
        self.enqueue_blocks = 0
        self.kept: dict[int, torch.Tensor] = {}
        self.traces: list = []
        self.traced_blocks = 0


def _call(fn, x, shape, win: Window, what: str):
    """One call into the program: its output, or None when it raised or
    returned another shape than ``shape`` (counted as failed)."""
    win.attempted += 1
    try:
        out = fn(x)
    except Exception:  # the window goes on: a failure is counted, not fatal
        win.failed += 1
        win.broken += 1
        if win.broken == 1:
            print(f"{what} raised:\n{traceback.format_exc()}", file=sys.stderr)
        return None
    if tuple(out.shape) != shape:
        win.failed += 1
        win.broken += 1
        return None
    return out


def run_closed(conv, stream, config: dict, traffic: dict, seconds: float, seed_rng: np.random.Generator,
               traced: bool, device) -> Window:
    """The closed loop; call 0 was set-up's warm-up, so the window's calls
    are 1, 2, ... of the stream."""
    win = Window()
    c, b, nb = config["channels"], config["block"], traffic["call_blocks"]
    shape = (c, nb * b)
    reservoir: list[tuple[int, torch.Tensor]] = []
    k = traffic["kept_calls"]
    seen = 0
    last = None

    def offer(i, out):
        nonlocal seen, last
        if out is None:
            return
        seen += 1
        if len(reservoir) < k:
            reservoir.append((i, out))
        else:
            j = int(seed_rng.integers(seen))
            if j < k:
                reservoir[j] = (i, out)
        last = (i, out)

    i = 1
    t0 = time.perf_counter()
    t_end = t0 + seconds
    if traced:
        # a profiled stretch of whole calls between two synchronisations,
        # then calls each started on an idle device, timed on the host alone
        sync(device)
        with trace_lib.profiled(win.traces):
            for _ in range(traffic["trace_calls"]):
                with torch.profiler.record_function("render.process"):
                    offer(i, _call(conv.process, stream.call_input(i), shape, win, "process"))
                i += 1
            sync(device)
        win.traced_blocks = traffic["trace_calls"] * nb
        for _ in range(traffic["enqueue_calls"]):
            sync(device)
            t = time.perf_counter()
            out = _call(conv.process, stream.call_input(i), shape, win, "process")
            win.enqueue_s.append(time.perf_counter() - t)
            offer(i, out)
            i += 1
        win.enqueue_blocks = traffic["enqueue_calls"] * nb
    while time.perf_counter() < t_end:
        offer(i, _call(conv.process, stream.call_input(i), shape, win, "process"))
        i += 1
    sync(device)
    win.seconds = time.perf_counter() - t0
    win.samples = (win.attempted - win.failed) * c * nb * b
    kept = dict(reservoir)
    if last is not None:
        kept[last[0]] = last[1]
    for ci, out in sorted(kept.items()):
        offsets = seed_rng.choice(nb, size=min(traffic["checked_blocks_per_call"], nb), replace=False)
        for o in sorted(int(v) for v in offsets):
            win.kept[ci * nb + o] = out[:, o * b : (o + 1) * b]
    return win


def _no_span(name):
    return contextlib.nullcontext()


def checked_callbacks(n: int, p: int, count: int, seed_rng: np.random.Generator) -> set[int]:
    """Callbacks 1 .. n whose outputs are checked: half drawn from those
    whose history reaches back to the stream's start (g < P), half from
    those past it, and the last."""
    early = np.arange(1, min(p, n + 1))
    late = np.arange(min(p, n + 1), n + 1)
    pick = set()
    for pool, want in ((early, count // 2), (late, count - count // 2)):
        if pool.size:
            pick.update(int(v) for v in seed_rng.choice(pool, size=min(want, pool.size), replace=False))
    return pick | {n}


def run_open(conv, stream, config: dict, traffic: dict, seconds: float, seed_rng: np.random.Generator,
             traced: bool, device) -> Window:
    """The open loop at the audio clock; callback 0 was set-up's warm-up,
    so the window's callbacks are 1 .. n, n = seconds * rate."""
    win = Window()
    c, b = config["channels"], config["block"]
    period = b / config["sample_rate"]
    deadline = traffic["deadline_periods"] * period
    n = callbacks(config, seconds)
    want = checked_callbacks(n, config["ring_partitions"], traffic["checked_calls"], seed_rng)
    first_traced = max(1, n + 1 - traffic["trace_calls"]) if traced else n + 1
    shape = (c, b)
    span = _no_span
    t0 = time.perf_counter() + period
    with contextlib.ExitStack() as stack:
        for g in range(1, n + 1):
            if g == first_traced:  # the last ``trace_calls`` callbacks, so stopping disturbs none
                stack.enter_context(trace_lib.profiled(win.traces))
                span = torch.profiler.record_function
            due = t0 + (g - 1) * period
            with span("live.wait"):
                while time.perf_counter() < due:
                    pass
            with span("live.callback"):
                with span("live.call"):
                    out = _call(conv, stream.call_input(g), shape, win, "__call__")
                with span("live.d2h"):
                    host = None if out is None else out.cpu()
            late = time.perf_counter() - due
            win.latencies.append(late)
            if out is not None and late > deadline:
                win.failed += 1
            if host is not None and g in want:
                win.kept[g] = host
    win.traced_blocks = n + 1 - first_traced
    return win
