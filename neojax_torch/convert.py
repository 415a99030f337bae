"""Carry params and streaming state between ``neojax`` and this package,
for the per-block convolver, the nested, hybrid and chunked engines and
the distributed engines of ``dist``.

Both packages use the same dict keys and shapes, so the conversion is a
dtype/device move plus two layout differences:

- ``filt_rim8 [8, 2P, 2B]`` (the JAX package's eight pre-shifted copies of
  the shared fused filter, a TPU alignment workaround) becomes
  ``filt_rim [2P, 1, 2B]``: copy 0, rows ``[:2P]``;
- ring positions (``pos``, ``head_pos``, ``meta_pos``) and
  ``HybridStream``'s block phase ``r`` are Python ints here.

A sparse filter's ``mask`` and ``sp_*`` schedule tables carry over as they
are (int32 tables, bool ``mask`` and ``sp_lane``): the port builds the same
tables and its kernels read them. The port's own tables (B4's ``tile_live``,
B3's ``tap_tiles``; not neojax keys) are built from the carried tables and
mask by ``conv.convolver.port_tables``, as ``filter_params`` builds them.

Like the other entry points, each ``*_from_neojax`` puts its tensors on the
card unless given ``device`` (``"cpu"`` for the kernels' plain versions),
and raises without a card rather than fall back to the CPU.

The distributed engines' ``*_from_neojax`` take ``neojax``'s global
arrays (as numpy) and the port engine, and return this rank's shard on the
engine's device: :func:`local_shard` cuts a rank's block by a JAX-style
spec, the layout ``neojax``'s ``shard_map`` gives it. :func:`gather_shards`
goes the other way, for tests and checks: every rank's shard, assembled
into the global array (a collective call).

Inputs are numpy arrays (``np.asarray`` of the JAX arrays). bfloat16 arrays
may arrive as numpy's ``bfloat16`` extension dtype or as float32 holding
bf16 values; :func:`state_to_numpy` returns bf16 planes as float32 (an exact
widening), so it needs no bfloat16 numpy type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neojax_torch.conv import chunked as chunked_lib
from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv import hybrid as hybrid_lib
from neojax_torch.conv import nested as nested_lib
from neojax_torch.conv.convolver import PartitionedConfig, _host, port_tables
from neojax_torch.core.device import resolve_device

__all__ = [
    "params_from_neojax",
    "state_from_neojax",
    "nested_params_from_neojax",
    "nested_state_from_neojax",
    "hybrid_params_from_neojax",
    "hybrid_state_from_neojax",
    "chunked_params_from_neojax",
    "chunked_state_from_neojax",
    "state_to_numpy",
    "local_shard",
    "gather_shards",
    "pipeline_filter_from_neojax",
    "pipeline_state_from_neojax",
    "binsharded_filter_from_neojax",
    "binsharded_state_from_neojax",
    "partnested_params_from_neojax",
    "partnested_state_from_neojax",
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
    if "mask" in params:
        params.update(port_tables(config, params, _host(params["mask"])))
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


def chunked_params_from_neojax(config: PartitionedConfig, params_np: dict, device=None) -> dict:
    """neojax ``chunked_filter_params`` output (as numpy) -> this package's:
    each bucket's ``tcat`` in the storage's dtype (bf16 for ``"bf16"``),
    ``bins`` int32, ``band`` an int."""
    device = resolve_device(device)
    return {"buckets": tuple(
        {"tcat": _tensor(bk["tcat"], device, chunked_lib._dtype(config)),
         "bins": _tensor(bk["bins"], device, torch.int32),
         "band": int(bk["band"])}
        for bk in params_np["buckets"]
    )}


def chunked_state_from_neojax(config: PartitionedConfig, state_np: dict, device=None) -> dict:
    """neojax ``chunked_init_state``/``process_chunked`` state (as numpy) ->
    this package's state on ``device``."""
    device = resolve_device(device)
    return {"tail": _tensor(state_np["tail"], device, torch.float32),
            "hists": tuple(_tensor(h, device, chunked_lib._dtype(config)) for h in state_np["hists"])}


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
    """This package's state (convolver, nested, hybrid, chunked or
    ``HybridStream``) -> numpy arrays with the JAX package's layout (positions and ``r`` as
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


# ------------------------------------------------------- distributed engines


def local_shard(array, mesh, spec) -> np.ndarray:
    """This rank's block of the global numpy ``array`` by a JAX-style spec,
    e.g. ``(None, "part", "ch", None)`` (a copy)."""
    array = np.asarray(array)
    return np.array(array[mesh.block(spec, array.shape)])


def gather_shards(t, mesh, spec) -> np.ndarray:
    """The global array (numpy) whose blocks by ``spec`` are the ranks'
    ``t``: every rank of the world calls it and gets the whole array
    (ranks outside ``mesh`` pass None). A collective call through host
    memory, for tests and checks only."""
    import torch.distributed as dist

    local = None if t is None else (_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t))
    if not (dist.is_available() and dist.is_initialized()):
        return local
    items = [None] * dist.get_world_size()
    dist.all_gather_object(items, (mesh.coords, local) if mesh.member else None)
    items = [item for item in items if item is not None]
    ref = items[0][1]
    spec = tuple(spec) + (None,) * (ref.ndim - len(spec))
    shape = []
    for dim, names in zip(ref.shape, spec):
        names = () if names is None else (names,) if isinstance(names, str) else tuple(names)
        shape.append(dim * int(np.prod([mesh.shape[n] for n in names], dtype=int)))
    out = np.empty(shape, ref.dtype)
    for coords, arr in items:
        out[mesh.block(spec, shape, coords)] = arr
    return out


def _planes_to_complex(filt) -> np.ndarray:
    filt = np.asarray(filt)
    if np.iscomplexobj(filt):
        return filt.astype(np.complex64)
    return (filt[0].astype(np.float32) + 1j * filt[1].astype(np.float32)).astype(np.complex64)


def pipeline_filter_from_neojax(pipe, filt_np) -> torch.Tensor:
    """neojax ``PipelineConvolver.shard_filter`` output (global, as numpy:
    split planes [2, P, C, K] or complex [P, C, K]) -> this rank's filter
    of the port's ``PipelineConvolver`` (``pipe``)."""
    return pipe.shard_filter(_planes_to_complex(filt_np))


def _place_numpy(state_np: dict, mesh, specs: dict, dtypes: dict, device) -> dict:
    out = {}
    for key, value in state_np.items():
        if key in _INT_KEYS:
            out[key] = int(np.asarray(value))
        else:
            out[key] = _tensor(local_shard(value, mesh, specs[key]), device, dtypes.get(key, torch.float32))
    return out


def pipeline_state_from_neojax(pipe, state_np: dict) -> dict:
    """neojax ``PipelineConvolver`` state (global, as numpy) -> this rank's
    state of ``pipe`` on its device (a plain slice: same layout)."""
    sdt = fdl_lib.STORAGE_DTYPES[pipe.config.storage]
    return _place_numpy(state_np, pipe.mesh, pipe._specs(), {"fdl": sdt, "incoming": sdt}, pipe.mesh.device)


def binsharded_filter_from_neojax(bc, filt_np) -> torch.Tensor:
    """neojax ``BinShardedConvolver.shard_filter`` output (global tiled,
    padded planes [2, 2P, C|1, K_pad], as numpy) -> this rank's filter of
    the port's ``BinShardedConvolver`` (``bc``)."""
    filt_np = np.asarray(filt_np, np.float32)
    spec = (None, None, "ch" if filt_np.shape[2] > 1 else None, "bin")
    return _tensor(local_shard(filt_np, bc.mesh, spec), bc.mesh.device, torch.float32)


def binsharded_state_from_neojax(bc, state_np: dict) -> dict:
    """neojax ``BinShardedConvolver`` state (global, as numpy) -> this
    rank's state of ``bc`` on its device."""
    specs = {"tail": ("ch", None), "fdl": (None, None, "ch", "bin"), "scl": (None, "ch", "bin")}
    return _place_numpy(state_np, bc.mesh, specs, {"fdl": fdl_lib.STORAGE_DTYPES[bc.config.storage]},
                        bc.mesh.device)


def partnested_params_from_neojax(eng, params_np: dict) -> dict:
    """neojax ``partnested_filter_params`` output (global tiled
    [D * 2L, C', K, 2S], as numpy) -> this rank's params of the port's
    ``PartShardedNested`` (``eng``); bf16 storage keeps a bf16 filter."""
    dtype = torch.bfloat16 if eng.config.storage == "bf16" else torch.float32
    out = {}
    for key, value in params_np.items():
        spec = ("part", "ch" if np.asarray(value).shape[1] > 1 else None)
        out[key] = _tensor(local_shard(value, eng.mesh, spec), eng.mesh.device, dtype)
    return out


def partnested_state_from_neojax(eng, state_np: dict) -> dict:
    """neojax ``partnested_init_state`` / ``PartShardedNested.process``
    state (global, as numpy) -> this rank's state of ``eng``."""
    specs = {"tail": ("ch", None), "prev": (None, "ch"), "fdl": (None, "part", "ch"), "scales": ("part", "ch")}
    dtypes = {"fdl": nested_lib._storage_dtype(eng.config), "prev": nested_lib._prev_dtype(eng.config)}
    return _place_numpy(state_np, eng.mesh, specs, dtypes, eng.mesh.device)
