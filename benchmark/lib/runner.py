"""One run of one cell: set-up, the window, the check, the metrics and
the result line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.lib import check, inputs, spec, system, traffic as traffic_lib, work
from benchmark.lib import trace as trace_lib

__all__ = ["FORBIDDEN", "forbidden_modules", "Run", "run_cell", "result_line"]

# Top-level module names a run must not load: the JAX package and JAX.
FORBIDDEN = {"jax", "jaxlib", "flax", "neojax"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Run:
    """What the metric readers read: the cell, set-up seconds, the window,
    its traces, and the least bytes of one call."""

    def __init__(self, cell: dict, setup_s: float, window, least_bytes_per_call: int, hbm_bytes_per_s):
        self.cell = cell
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.setup_s = setup_s
        self.window = window
        self.least_bytes_per_call = least_bytes_per_call
        self.hbm_bytes_per_s = hbm_bytes_per_s

    @property
    def trace(self):
        return self.window.traces[0] if self.window.traces else None


def _power_limit_w():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(res.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
             overrides: dict | None = None, control: bool = False) -> dict:
    """Run the cell (``spec.cell`` / ``spec.cell_for``) once and return its
    result (the line's keys, and ``checks``). ``t_start``: the host clock
    when the process started. ``overrides``: ``{"config": {...},
    "traffic": {...}}`` updates (the CPU tests' small sizes), after which
    the configuration must still take the mix (``spec.check_pairing``).
    ``control``:
    run the configuration's control in the program's place instead:
    ``{"kind": "program", "storage": S}`` is the program at the lower
    storage S, ``{"kind": "stand_in", "precision": P}`` the reference
    computed at precision P."""
    cell = dict(cell)
    for part, upd in (overrides or {}).items():
        cell[part] = {**cell[part], **upd}
    config, tr = cell["config"], cell["traffic"]
    spec.check_pairing(config, tr, f"cell {cell['workload']['name']}")
    ctl = config["control"] if control else {}
    storage = ctl.get("storage")
    device = torch.device(device)
    cuda = device.type == "cuda"

    filt = inputs.make_filter(config)
    calls = 1 + traffic_lib.callbacks(config, seconds) if tr.get("host_io") else None
    stream = inputs.make_stream(config, tr, seed, calls, device)
    seed_rng = np.random.default_rng(inputs.substream_seed(seed, 2))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    system.reset_counters()
    conv = system.build(config, filt, device, storage)
    entry = conv.process if tr["entry"] == "process" else conv
    warm = entry(stream.call_input(0))
    warm = warm.cpu() if tr.get("host_io") else warm
    traffic_lib.sync(device)
    if traced:
        trace_lib.warm_profiler(device)
    setup_s = time.perf_counter() - t_start

    run_loop = traffic_lib.run_closed if tr["loop"] == "closed" else traffic_lib.run_open
    win = run_loop(conv, stream, config, tr, seconds, seed_rng, traced, device)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del conv, entry, warm
    checks = check.judge(win.kept, stream, filt, config, device, ctl.get("precision"))
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    peaks = work.PEAKS.get(name, {})
    least = work.least_bytes(config["channels"], config["block"], tr["call_blocks"], filt.live,
                             storage or config["storage"], peaks.get("onchip_bytes", 0))
    run = Run(cell, setup_s, win, least, peaks.get("hbm_bytes_per_s"))

    metrics = {}
    for m in cell["per_layer"] if traced else cell["end_to_end"]:
        value = spec.metric_reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = _power_limit_w()
    correct = bool(win.kept) and not win.broken and check.passed(checks)
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed, "metrics": metrics,
              "device": dev}
    t = run.trace
    if traced and t is not None and t.device_ops:
        a, b = t.window(traffic_lib.STRETCH_SPAN[tr["loop"]])
        dev["busy_s"] = t.busy_in(a, b)
        dev["window_s"] = b - a
        result["breakdown"] = t.breakdown(a, b)
    result["checks"] = checks
    return result


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def result_line(result: dict) -> str:
    """The result as one JSON line, ``checks`` last; a non-finite number
    compared is written as null."""
    out = {k: v for k, v in result.items() if k != "checks"}
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in result["checks"].items()}
    return json.dumps(out)
