"""Channel-sharded chunked, nested and hybrid processing
(``neojax.dist.sharded_chunked``).

The throughput engines with the data-parallel mesh axis: every state
tensor of the chunked (``hists [Kb, 2M, C]``), nested (meta ring
``[2, P2, C, K, 2S]``) and hybrid engines carries the channel axis, so
splitting it over "ch" keeps every product, transform and kernel launch
local to its rank — zero collectives. Each rank runs the single-card
engine on its channels: the chunked engine's ``torch.bmm`` product, the
nested engine's B5 meta MAC, the hybrid's fused head (B3 with
``acc_add``) or unfused head (B1) plus its B5 tail.

Shared filters are kept whole; per-channel filters keep this rank's
channels (dim 1). Each function returns (this rank's state, this rank's
output [C/D, T]) and takes global or this rank's state.
"""

from __future__ import annotations

import torch

from neojax_torch.conv import chunked, hybrid, nested
from neojax_torch.conv.convolver import PartitionedConfig
from neojax_torch.dist.mesh import Mesh
from neojax_torch.dist.sharded import local_config, place_signal, place_state

__all__ = [
    "shard_chunked_state",
    "sharded_process_chunked",
    "shard_nested_state",
    "sharded_process_nested",
    "shard_hybrid_state",
    "sharded_process_hybrid",
]


def shard_chunked_state(state: dict, mesh: Mesh, channels: int | None = None) -> dict:
    """This rank's chunked state: ``tail`` [C, B] and each of ``hists``
    [Kb, 2M, C] keep this rank's channels. ``channels``: the global count
    (None: ``state`` is global)."""
    c = channels or state["tail"].shape[0]
    return {"tail": place_state({"t": state["tail"]}, mesh, {"t": ("ch", None)}, c)["t"],
            "hists": tuple(place_state({"h": h}, mesh, {"h": (None, None, "ch")}, c)["h"]
                           for h in state["hists"])}


def _replicated(tree, device):
    if isinstance(tree, dict):
        return {k: _replicated(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replicated(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def sharded_process_chunked(config: PartitionedConfig, params: dict, state: dict, signal, mesh: Mesh,
                            chunk_blocks: int):
    """Channel-sharded ``process_chunked`` (shared filter: params kept
    whole)."""
    return chunked.process_chunked(
        local_config(config, mesh), _replicated(params, mesh.device),
        shard_chunked_state(state, mesh, config.channels), place_signal(signal, config.channels, mesh),
        chunk_blocks,
    )


_NESTED_SPECS = {
    "tail": ("ch", None),
    "prev": (None, "ch", None, None),
    "fdl": (None, None, "ch", None, None),
    "scales": (None, "ch", None, None),
}


def shard_nested_state(state: dict, mesh: Mesh, channels: int | None = None) -> dict:
    """This rank's nested state: the channel axis is dim 0 of ``tail``
    [C, B], dim 1 of ``prev`` [2, C, K, S] and ``scales`` [P2, C, K, G],
    dim 2 of ``fdl`` [2, P2, C, K, 2S]; ``pos`` stays an int."""
    return place_state(state, mesh, _NESTED_SPECS, channels or state["tail"].shape[0])


def _filter_params(params: dict, mesh: Mesh, per_channel: bool, channels: int) -> dict:
    """Filter tensors [rows, C'|1, ...]: this rank's channels (dim 1) when
    per-channel, else whole."""
    out = {}
    for key, val in params.items():
        if per_channel and val.shape[1] in (channels, channels // mesh.shape.get("ch", 1)):
            shape = list(val.shape)
            shape[1] = channels
            out[key] = mesh.place(val, (None, "ch"), tuple(shape))
        else:
            out[key] = val.to(mesh.device)
    return out


def sharded_process_nested(config: PartitionedConfig, params: dict, state: dict, signal, mesh: Mesh):
    """Channel-sharded ``process_nested``: B5 on each rank's meta ring.

    Shared filters are kept whole; per-channel filters keep this rank's
    channels (dim 1 of [P2, C, K, 2S]) so filter reads stay rank-local."""
    per_channel = params["filt_re"].shape[1] > 1
    return nested.process_nested(
        local_config(config, mesh), _filter_params(params, mesh, per_channel, config.channels),
        shard_nested_state(state, mesh, config.channels), place_signal(signal, config.channels, mesh),
    )


def _hybrid_specs(state: dict) -> dict:
    """Channel axes: btail [C, B] dim 0; head_fdl [2, S, C, K] dim 2 (its
    scales [S, C, 1] dim 1); head_dcny [S, C, 2] dim 1; meta_fdl
    [2, P2, C, K, 2S] dim 2; prev_spec / tail_frames [2, C, K, S] dim 1;
    meta_scales [P2, C, K, G] dim 1."""
    head = (None, None, "ch", None)
    return {
        "btail": ("ch", None),
        "head_fdl": (head, (None, "ch", None)) if isinstance(state["head_fdl"], tuple) else head,
        "head_dcny": (None, "ch", None),
        "meta_fdl": (None, None, "ch", None, None),
        "prev_spec": (None, "ch", None, None),
        "tail_frames": (None, "ch", None, None),
        "meta_scales": (None, "ch", None, None),
    }


def shard_hybrid_state(state: dict, mesh: Mesh, channels: int | None = None) -> dict:
    """This rank's hybrid state (channel axes as :func:`_hybrid_specs`);
    the ring positions stay ints."""
    return place_state(state, mesh, _hybrid_specs(state), channels or state["btail"].shape[0])


def sharded_process_hybrid(config: PartitionedConfig, params: dict, state: dict, signal, mesh: Mesh):
    """Channel-sharded ``process_hybrid`` — the real-time (single-block
    latency) engine over the data-parallel mesh axis. Shared filters are
    kept whole; per-channel filters keep this rank's channels, so head and
    tail filter reads stay rank-local."""
    c = config.channels
    per_channel = params["head_re"].shape[1] > 1
    local = {k: params[k] for k in ("head_re", "head_im")}
    local = _filter_params(local, mesh, per_channel, c)
    for key in ("head_packed", "tail"):
        if key in params:
            sub = {k: v for k, v in params[key].items() if not k.startswith("sp_") and k != "tile_live"}
            local[key] = _filter_params(sub, mesh, per_channel, c)
    return hybrid.process_hybrid(local_config(config, mesh), local, shard_hybrid_state(state, mesh, c),
                                 place_signal(signal, c, mesh))
