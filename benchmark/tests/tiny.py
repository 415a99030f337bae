"""Small sizes at which a cell runs on the CPU (the kernels' plain
versions) in a few seconds: the same code path, 2 channels, block 64, 24
ring partitions, a 4.8 kHz clock (13.3 ms a live callback).

A configuration file may carry a ``"tiny"`` object, merged over these
(``"ir"`` over the configuration's own ``ir``), e.g. ``{"ring_partitions":
32, "chunk_blocks": 8, "ir": {"partitions": 30}}``. Without one its IR
takes ``IR_PARTITIONS`` of its generator, or the whole ring."""

import time

from benchmark.lib import runner, spec

CONFIG = {"channels": 2, "block": 64, "sample_rate": 4800, "ring_partitions": 24}
# the IR's partitions of a configuration without a "tiny" object
IR_PARTITIONS = {"decaying_noise": 20, "octave_room": 24}
TRAFFIC = {
    "render": {"call_blocks": 32, "trace_calls": 2, "enqueue_calls": 2},
    "live": {"trace_calls": 8},
}

# every configuration under every traffic mix it takes, listed in BENCHMARK.json or not
MIXES = [(c["name"], t) for c in spec.benchmark()["configs"] for t in spec.mixes(c["name"]) if t in TRAFFIC]


def overrides(cell: dict) -> dict:
    """``runner.run_cell``'s ``overrides`` for a cell."""
    own = cell["config"].get("tiny", {})
    config = {**CONFIG, **{k: v for k, v in own.items() if k != "ir"}}
    ir = dict(cell["config"]["ir"])
    ir["partitions"] = IR_PARTITIONS.get(ir["generator"], config["ring_partitions"])
    config["ir"] = {**ir, **own.get("ir", {})}
    return {"config": config, "traffic": dict(TRAFFIC[cell["workload"]["traffic"]])}


def run(mix, seed: int, device="cpu", traced: bool = False, seconds: float = 0.5, **kw) -> dict:
    """One run of ``mix`` = (configuration, traffic) at the small sizes; the
    configuration is a name or the path of its file."""
    cell = spec.cell_for(*mix)
    return runner.run_cell(cell, seed, seconds, traced, time.perf_counter(), device=device,
                           overrides=overrides(cell), **kw)
