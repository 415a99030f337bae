"""Weak-scaling harness: samples/s per rank across mesh sizes
(``neojax.bench.scaling``).

BASELINE.md's third north-star metric is 1 -> N-device scaling efficiency
(>= 0.9) of the channel-sharded streaming convolution. Weak scaling is
the natural audio axis: channels grow with ranks, every rank serves its
own channel block, and the channel-sharded engine has no collective.

    eff(N) = per-rank samples/s at N ranks / per-rank samples/s at the
             smallest measured mesh

Called on every rank of a process group. Each device count n runs on the
first n ranks (a mesh of its own) with ``channels_per_device * n``
channels through ``dist.sharded_process_nested``, best of 3. As in
``neojax``, each rank's shard of the signal is on its device before the
clock starts; a rank's time ends with a host fetch of its output, and a
point's time is the slowest rank's (``all_reduce(MAX)``, which ranks
outside the point's mesh join with 0). Ranks that share one card measure
that card's throughput, not scaling.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from neojax_torch.conv import nested
from neojax_torch.conv.convolver import PartitionedConfig
from neojax_torch.conv.partition import uniform_partition
from neojax_torch.dist.mesh import _world, make_mesh, rank_device
from neojax_torch.dist.sharded_chunked import sharded_process_nested

__all__ = ["ScalingPoint", "weak_scaling_sweep"]


@dataclasses.dataclass
class ScalingPoint:
    devices: int
    channels: int
    samples_per_sec: float
    per_device: float
    efficiency: float


def _best_seconds(config, params, state, sig, mesh) -> float:
    """This rank's best of 3 runs on its shard ``sig`` (on its device),
    each ending in a host fetch."""
    best = None
    for _ in range(3):
        st = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in state.items()}
        t0 = time.perf_counter()
        _, out = sharded_process_nested(config, params, st, sig, mesh)
        float(torch.sum(torch.abs(out[:, -8:])))  # host fetch: the device is done
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _slowest(seconds: float, device) -> float:
    """The largest of every rank's ``seconds`` (0 from ranks outside the
    point's mesh); a host number, so it rides a CPU tensor under gloo and
    a tensor on the rank's own ``device`` under NCCL (a member or not)."""
    if not (dist.is_available() and dist.is_initialized()):
        return seconds
    on = device if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([seconds], dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def weak_scaling_sweep(device_counts=None, channels_per_device: int = 8, block_size: int = 512,
                       num_partitions: int = 256, chunk_blocks: int = 64, seconds: float = 10.0,
                       storage: str = "bf16", device=None):
    """Run the channel-sharded nested engine at growing mesh sizes, on
    every rank. ``device``: each rank's device (None: the card).

    Returns a list of ScalingPoint (efficiency relative to the first
    point, per-rank channels fixed at ``channels_per_device``)."""
    rank, world = _world()
    dev = rank_device(device)
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    rng = np.random.default_rng(0)
    nb = int(seconds * 48000) // block_size
    nb -= nb % chunk_blocks
    ir = rng.uniform(-1, 1, (1, num_partitions * block_size)).astype(np.float32) * 0.05

    points: list[ScalingPoint] = []
    base = None
    for d in device_counts:
        ch = channels_per_device * d
        config = PartitionedConfig(block_size, num_partitions, channels=ch, storage=storage)
        sig = rng.uniform(-1, 1, (ch, nb * block_size)).astype(np.float32)
        mesh = make_mesh(ch=d, device=dev, ranks=range(d))
        secs = 0.0
        if mesh.member:
            params = nested.nested_filter_params(config, uniform_partition(ir, block_size), chunk_blocks,
                                                 device=dev)
            state = nested.nested_init_state(config, params)
            local = mesh.place(sig, ("ch", None), sig.shape, torch.float32)
            secs = _best_seconds(config, params, state, local, mesh)
        sps = ch * nb * block_size / _slowest(secs, dev)
        base = sps / d if base is None else base
        points.append(ScalingPoint(devices=d, channels=ch, samples_per_sec=sps, per_device=sps / d,
                                   efficiency=(sps / d) / base))
    return points
