"""Profiling and structured run reporting.

Port of ``neojax.bench.profile``: a ``torch.profiler`` trace in place of
``jax.profiler`` (CPU activity, and the card's kernels when a card is
visible), written as a Chrome trace into the directory the caller names,
plus structured per-run JSON records (config, samples/s, roofline
fraction, SNR) with the JAX package's fields.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

__all__ = ["trace", "kernel_timeline", "RunRecord", "emit_record"]


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


@dataclasses.dataclass
class RunRecord:
    """Structured result of one benchmark/parity run."""

    name: str
    config: dict
    samples_per_sec: float | None = None
    seconds: float | None = None
    roofline_fraction: float | None = None
    snr_db: float | None = None
    extra: dict = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def emit_record(record: RunRecord, stream=None) -> None:
    print(record.to_json(), file=stream or sys.stderr)
