"""Profiling.

Port of ``neojax.bench.profile``'s trace: a ``torch.profiler`` trace in
place of ``jax.profiler`` (CPU activity, and the card's kernels when a card
is visible), written as a Chrome trace into the directory the caller
names. The program's spans (``neojax_torch.trace``) appear in it as
``user_annotation`` events around the kernels they launched.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

__all__ = ["trace", "kernel_timeline"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed workload and write ``trace.json`` (Chrome
    trace format) into ``log_dir``; yields the profiler, whose
    ``key_averages()`` sums time by kernel::

        with profile.trace("traces/process") as prof:
            out = conv.process(sig)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_timeline(fn, calls: int = 3) -> list[list[tuple[str, float]]]:
    """The card kernels each of ``calls`` calls of ``fn`` runs, in launch
    order: per call a list of (kernel name, device µs), read from one
    Chrome trace in which a fill kernel marks where each call starts. A
    trace on the card has been seen to miss a kernel now and then, so take
    a statistic over the calls. Warm ``fn`` up first: the first call may
    build and allocate."""
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            for _ in range(calls):
                marker.zero_()
                fn()
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    out: list[list[tuple[str, float]]] = []
    for e in sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"]):
        if "FillFunctor" in e["name"]:
            out.append([])
        elif out:
            out[-1].append((e["name"], float(e["dur"])))
    return out

