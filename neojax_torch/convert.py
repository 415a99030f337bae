"""Carry params and streaming state between ``neojax`` and this package,
for the per-block convolver, the nested engine and the hybrid engine.

Both packages use the same dict keys and shapes, so the conversion is a
dtype/device move plus two layout differences:

- ``filt_rim8 [8, 2P, 2B]`` (the JAX package's eight pre-shifted copies of
  the shared fused filter, a TPU alignment workaround) becomes
  ``filt_rim [2P, 1, 2B]``: copy 0, rows ``[:2P]``;
- ring positions (``pos``, ``head_pos``, ``meta_pos``) and
  ``HybridStream``'s block phase ``r`` are Python ints here.

A sparse filter's ``mask`` and ``sp_*`` schedule tables carry over as they
are (int32 tables, bool ``mask`` and ``sp_lane``): the port builds the same
tables and its kernels read them.

Like the other entry points, each ``*_from_neojax`` puts its tensors on the
card unless given ``device`` (``"cpu"`` for the kernels' plain versions),
and raises without a card rather than fall back to the CPU.

Inputs are numpy arrays (``np.asarray`` of the JAX arrays). bfloat16 arrays
may arrive as numpy's ``bfloat16`` extension dtype or as float32 holding
bf16 values; :func:`state_to_numpy` returns bf16 planes as float32 (an exact
widening), so it needs no bfloat16 numpy type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv import hybrid as hybrid_lib
from neojax_torch.conv import nested as nested_lib
from neojax_torch.conv.convolver import PartitionedConfig
from neojax_torch.core.device import resolve_device

__all__ = [
    "params_from_neojax",
    "state_from_neojax",
    "nested_params_from_neojax",
    "nested_state_from_neojax",
    "hybrid_params_from_neojax",
    "hybrid_state_from_neojax",
    "state_to_numpy",
]

_INT_KEYS = ("pos", "head_pos", "meta_pos", "r")


def _tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # the JAX package's extension dtype
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_neojax(config: PartitionedConfig, params_np: dict, device=None) -> dict:
    """neojax ``filter_params`` output (as numpy) -> this package's params."""
    device = resolve_device(device)
    params = {}
    for key, value in params_np.items():
        if key.startswith("sp_"):
            params[key] = _tensor(value, device, torch.bool if key == "sp_lane" else torch.int32)
        elif key == "filt_rim8":
            p2 = 2 * config.num_partitions
            rim = np.asarray(value)[0, :p2][:, None, :]  # [2P, 1, 2B]
            params["filt_rim"] = _tensor(rim, device)
        else:
            params[key] = _tensor(value, device)
    return params


def state_from_neojax(config: PartitionedConfig, state_np: dict, device=None) -> dict:
    """neojax ``init_state``/``step``/``process`` state (as numpy) -> this
    package's state on ``device``."""
    return _state_dict(state_np, resolve_device(device), {"fdl": fdl_lib.STORAGE_DTYPES[config.storage]})


def nested_params_from_neojax(config: PartitionedConfig, params_np: dict, device=None) -> dict:
    """neojax ``nested_filter_params`` output (as numpy) -> this package's
    (the bf16 storage keeps a bf16 filter)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if config.storage == "bf16" else torch.float32
    return {key: _tensor(value, device, dtype) for key, value in params_np.items()}


def nested_state_from_neojax(config: PartitionedConfig, state_np: dict, device=None) -> dict:
    """neojax ``nested_init_state``/``process_nested`` state (as numpy) ->
    this package's state on ``device``."""
    dtypes = {"fdl": nested_lib._storage_dtype(config), "prev": nested_lib._prev_dtype(config)}
    return _state_dict(state_np, resolve_device(device), dtypes)


def hybrid_params_from_neojax(config: PartitionedConfig, params_np: dict, device=None) -> dict:
    """neojax ``hybrid_filter_params`` output (as numpy) -> this package's:
    ``head_packed`` as the convolver's params (``filt_rim8`` -> ``filt_rim``;
    the head has no mask), ``tail`` as the nested engine's."""
    device = resolve_device(device)
    s = np.asarray(params_np["head_re"]).shape[0] // 2
    params = {}
    for key, value in params_np.items():
        if key == "head_packed":
            head_cfg = dataclasses.replace(config, num_partitions=s,
                                           storage=hybrid_lib._head_storage(config))
            params[key] = params_from_neojax(head_cfg, value, device)
        elif key == "tail":
            params[key] = nested_params_from_neojax(config, value, device)
        else:
            params[key] = _tensor(value, device, torch.float32)
    return params


def hybrid_state_from_neojax(config: PartitionedConfig, state_np: dict, device=None) -> dict:
    """neojax ``hybrid_init_state``/``process_hybrid`` (or ``HybridStream``)
    state (as numpy) -> this package's state on ``device``. Head scales
    keep only the C real channels (a 128-lane-padded scale table is cut
    back)."""
    dtypes = {
        "head_fdl": fdl_lib.STORAGE_DTYPES[hybrid_lib._head_storage(config)],
        "meta_fdl": nested_lib._storage_dtype(config),
        "prev_spec": nested_lib._prev_dtype(config),
    }
    state = _state_dict(state_np, resolve_device(device), dtypes)
    if isinstance(state["head_fdl"], tuple):
        planes, scales = state["head_fdl"]
        state["head_fdl"] = (planes, scales[:, : config.channels].contiguous())
    return state


def _state_dict(state_np: dict, device, dtypes: dict) -> dict:
    """numpy state -> tensors: ints for the positions, ``dtypes[key]`` for
    the keyed arrays (the first element of a (planes, scales) tuple),
    float32 otherwise."""
    state = {}
    for key, value in state_np.items():
        if key in _INT_KEYS:
            state[key] = int(np.asarray(value))
        elif isinstance(value, (tuple, list)):
            planes, scales = value
            state[key] = (_tensor(planes, device, dtypes[key]), _tensor(scales, device, torch.float32))
        else:
            state[key] = _tensor(value, device, dtypes.get(key, torch.float32))
    return state


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def state_to_numpy(state: dict) -> dict:
    """This package's state (convolver, nested, hybrid or ``HybridStream``)
    -> numpy arrays with the JAX package's layout (positions and ``r`` as
    int32 scalars, bf16 arrays widened to float32)."""
    out = {}
    for key, value in state.items():
        if key in _INT_KEYS:
            out[key] = np.int32(value)
        elif isinstance(value, tuple):
            out[key] = tuple(_numpy(v) for v in value)
        else:
            out[key] = _numpy(value)
    return out
