"""Small sizes at which a cell runs on the CPU (the kernels' plain
versions) in a few seconds: the same code path, 2 channels, block 64, 24
ring partitions, a 4.8 kHz clock (13.3 ms a live callback)."""

import time

from benchmark.lib import runner, spec

CONFIG = {"channels": 2, "block": 64, "sample_rate": 4800, "ring_partitions": 24}
IR_PARTITIONS = {"decaying_noise": 20, "octave_room": 24}
TRAFFIC = {
    "render": {"call_blocks": 32, "trace_calls": 2, "enqueue_calls": 2},
    "live": {"trace_calls": 8},
}
# every configuration under every traffic mix, listed in BENCHMARK.json or not
MIXES = [(c["name"], t) for c in spec.benchmark()["configs"] for t in sorted(TRAFFIC)]


def overrides(cell: dict) -> dict:
    """``runner.run_cell``'s ``overrides`` for a cell."""
    config = dict(CONFIG)
    ir = dict(cell["config"]["ir"])
    ir["partitions"] = IR_PARTITIONS[ir["generator"]]
    config["ir"] = ir
    return {"config": config, "traffic": TRAFFIC[cell["workload"]["traffic"]]}


def run(mix, seed: int, device="cpu", traced: bool = False, seconds: float = 0.5, **kw) -> dict:
    """One run of ``mix`` = (configuration, traffic) at the small sizes."""
    cell = spec.cell_for(*mix)
    return runner.run_cell(cell, seed, seconds, traced, time.perf_counter(), device=device,
                           overrides=overrides(cell), **kw)
