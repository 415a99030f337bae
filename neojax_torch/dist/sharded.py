"""Channel-sharded (data-parallel) streaming convolution
(``neojax.dist.sharded``).

The reference runs one convolver per channel serially
(``extra/cli/src/convolver.cpp:37-55``); here the channel axis of every
piece of convolver state splits over the mesh "ch" axis and each rank runs
the per-block engine (``conv.process``: B3 on the card for the packed
split-plane ring) on its own channels — zero communication, the pure
data-parallel path, across hosts as on one.

Each rank's shard is its own contiguous copy on the rank's device; the
engine returns this rank's shard of the output (``[C/D, T]``, channels
``[r*C/D, (r+1)*C/D)`` for "ch" index r) and its local state, which a
second call takes back as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neojax_torch.conv import convolver as cv
from neojax_torch.dist.mesh import Mesh

__all__ = ["shard_params", "shard_state", "sharded_process"]

_CH = (None, "ch", None)  # [P, C, K]-shaped entries: channels on dim 1


def local_config(config: cv.PartitionedConfig, mesh: Mesh) -> cv.PartitionedConfig:
    """``config`` at this rank's channel count."""
    d = mesh.shape.get("ch", 1)
    if config.channels % d:
        raise ValueError(f"channels {config.channels} not divisible by mesh ch={d}")
    return dataclasses.replace(config, channels=config.channels // d)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def shard_params(config: cv.PartitionedConfig, params: dict, mesh: Mesh) -> dict:
    """This rank's filter params on its device. Shared (single-channel)
    filters are kept whole; per-channel filters keep this rank's channels
    (dim 1). A masked filter's schedule tables (``sp_*`` and the port's
    own, ``cv.PORT_TABLES``) are rebuilt for the local channel count from
    its sliced ``mask``, as ``Convolver`` rebuilds them when it binds a
    mono filter to more channels: their chunk geometry depends on the
    channel count."""
    local = local_config(config, mesh)
    out = {}
    for key, val in params.items():
        if key.startswith("sp_") or key in cv.PORT_TABLES:
            continue
        per_channel = val.shape[1] == config.channels and config.channels > 1
        if per_channel:
            out[key] = mesh.place(val, _CH, tuple(val.shape))
        else:
            out[key] = torch.as_tensor(val).to(mesh.device)
    if "mask" in out:
        out.update(cv._schedule_params(local, _host(out["mask"]), mesh.device))
    return out


def place_state(state: dict, mesh: Mesh, specs: dict, channels: int) -> dict:
    """Place each entry of ``state`` by ``specs[key]`` (a (planes, scales)
    tuple by a pair of specs) whose "ch" dim has the global length
    ``channels`` (an entry already at the local length is this rank's);
    int positions are kept."""
    out = {}
    for key, val in state.items():
        if isinstance(val, int):
            out[key] = val
        elif isinstance(val, tuple):
            out[key] = tuple(_place_one(v, mesh, s, channels) for v, s in zip(val, specs[key]))
        else:
            out[key] = _place_one(val, mesh, specs[key], channels)
    return out


def _place_one(val, mesh: Mesh, spec, channels: int) -> torch.Tensor:
    shape = list(val.shape)
    shape[spec.index("ch")] = channels  # the global shape
    return mesh.place(val, spec, tuple(shape))


def _fdl_spec(fdl) -> tuple:
    """The spec of a per-block FDL: dense [P, C, K], split [2, P, C, K] or
    the quantized (planes, scales [P, C, 1]) tuple."""
    if isinstance(fdl, tuple):
        return (None, None, "ch", None), _CH
    return _CH if fdl.ndim == 3 else (None, None, "ch", None)


def shard_state(config: cv.PartitionedConfig, state: dict, mesh: Mesh) -> dict:
    """This rank's convolver state: ``tail`` [C, B], ``fdl`` (dense, split
    or quantized tuple) and ``dcny`` [P, C, 2] keep this rank's channels;
    ``pos`` stays an int. A state that already has the local channel count
    (this rank's, from an earlier call) is taken as it is."""
    specs = {"tail": ("ch", None), "fdl": _fdl_spec(state["fdl"]), "dcny": _CH}
    return place_state(state, mesh, specs, config.channels)


def sharded_process(config: cv.PartitionedConfig, params: dict, state: dict, signal, mesh: Mesh):
    """Channel-sharded ``conv.process``: this rank's channels of ``signal``
    ([C, T], host or tensor) through the per-block engine on its device.

    ``params``/``state`` may be global (cut here) or this rank's (from
    :func:`shard_params`/:func:`shard_state` or an earlier call). Returns
    (this rank's state, this rank's output [C/D, T])."""
    local = local_config(config, mesh)
    return cv.process(local, shard_params(config, params, mesh), shard_state(config, state, mesh),
                      place_signal(signal, config.channels, mesh))


def place_signal(signal, channels: int, mesh: Mesh) -> torch.Tensor:
    """This rank's channels of a [C, T] signal (host or tensor), float32 on
    its device."""
    signal = signal if isinstance(signal, torch.Tensor) else torch.as_tensor(np.asarray(signal))
    return mesh.place(signal, ("ch", None), (channels, signal.shape[-1]), torch.float32)
