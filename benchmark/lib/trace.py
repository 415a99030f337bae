"""A ``torch.profiler`` trace of a stretch of the window, reduced to what
the per-layer metrics read: device operations, the benchmark's own spans
(``torch.profiler.record_function`` around its calls into the program),
device busy time as the union of device intervals, and the idle gaps
labelled with the span the host was in."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

__all__ = ["Trace", "profiled", "union"]

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


class Trace:
    """Events of one profiled stretch, times in seconds on the trace's clock."""

    def __init__(self, events: list[dict]):
        self.device_ops = []  # (name, cat, start, end)
        self.spans = []  # (name, start, end)
        for e in events:
            cat = str(e.get("cat", "")).lower()
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            if cat in _DEVICE_CATS:
                self.device_ops.append((e["name"], cat, a, b))
            elif cat == "user_annotation":
                self.spans.append((e["name"], a, b))
        self.busy = union((a, b) for _, _, a, b in self.device_ops)

    @property
    def kernels(self) -> int:
        return sum(1 for _, cat, _, _ in self.device_ops if cat == "kernel")

    def spans_named(self, name: str):
        return [(a, b) for n, a, b in self.spans if n == name]

    def window(self, span: str) -> tuple[float, float]:
        """From the first ``span`` to the end of the last span or device
        operation, whichever is later."""
        spans = self.spans_named(span)
        end = max([b for _, b in spans] + [b for _, _, _, b in self.device_ops])
        return min(a for a, _ in spans), end

    def busy_in(self, a: float, b: float) -> float:
        return _covered(self.busy, a, b)

    def busy_in_spans(self, span: str) -> tuple[float, float]:
        """(device busy seconds inside the ``span`` spans, their total
        length)."""
        spans = self.spans_named(span)
        return sum(self.busy_in(a, b) for a, b in spans), sum(b - a for a, b in spans)

    def _host_label(self, t: float) -> str:
        inside = [(a, -b, n) for n, a, b in self.spans if a <= t < b]
        return max(inside)[2] if inside else "harness"  # the latest-starting, then the shortest

    def breakdown(self, a: float, b: float, top: int = 10) -> dict:
        """The device operations that took most time (seconds by name) and
        the device's idle time by what the host was doing meanwhile
        (seconds by the innermost span the host was in; "harness" outside
        every span), in [a, b]."""
        by_op: dict[str, float] = {}
        for name, _, s, e in self.device_ops:
            if e > a and s < b:
                by_op[name[:160]] = by_op.get(name[:160], 0.0) + min(e, b) - max(s, a)
        gaps, t = [], a
        for s, e in self.busy:
            if s > t and t < b:
                gaps.append((t, min(s, b)))
            t = max(t, e)
        if t < b:
            gaps.append((t, b))
        edges = sorted({x for _, s, e in self.spans for x in (s, e)})
        by_label: dict[str, float] = {}
        for s, e in gaps:
            cuts = [s] + [x for x in edges if s < x < e] + [e]
            for u, v in zip(cuts, cuts[1:]):
                label = self._host_label((u + v) / 2)
                by_label[label] = by_label.get(label, 0.0) + v - u
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_label)}


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiled(result: list):
    """Profile the enclosed stretch; appends its :class:`Trace` to
    ``result`` on exit. The Chrome trace goes through a file in the run's
    temporary directory and is deleted once read."""
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            result.append(Trace(json.load(f)["traceEvents"]))
    finally:
        os.remove(path)


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so the first profiled stretch of
    the window does not pay its start-up."""
    with torch.profiler.profile(activities=_activities()):
        torch.zeros(1, device=device).add_(1)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
