"""Streaming-state checkpoint / resume as ``.npz`` (``neojax.io.checkpoint``).

A convolver's only persistent state is its streaming state (FDL ring
``dense_fdl.hpp:32``, overlap window ``overlap_save.hpp:55``, write pos
``fdl_index.hpp:40``): here a dict of tensors and Python-int positions, so
a stream resumes from the last block boundary by reloading it, exactly.

The file layout is ``neojax``'s, so each package reads the other's files:
one array per key, a quantized ring's (planes, scales) tuple as
``key.tuple0`` / ``key.tuple1``, the positions (``pos``, ``head_pos``,
``meta_pos``, ``r``) as 0-d int32 arrays, and bf16 arrays as the raw
two-byte ``|V2`` records numpy writes for the JAX package's bfloat16
arrays. No format version is written: ``neojax`` writes none. A state
from ``neojax`` is carried into this package's dtypes by
``convert.*state_from_neojax``, and this package's state goes the other way
by ``convert.state_to_numpy``.

``neojax``'s ``save_state_orbax`` / ``load_state_orbax`` (sharded
multi-host checkpoints) have their counterpart in :func:`save_state_dcp` /
:func:`load_state_dcp`, on ``torch.distributed.checkpoint``.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.device import resolve_device

__all__ = ["save_state", "load_state", "save_state_dcp", "load_state_dcp"]

_INT_KEYS = ("pos", "head_pos", "meta_pos", "r")
_BF16_RECORD = np.dtype("V2")


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(_BF16_RECORD)
        return value.numpy()
    if isinstance(value, int):
        return np.asarray(value, np.int32)
    return np.asarray(value)


def _items(state: dict):
    """(name, value) of each leaf: a tuple entry (quantized FDL (planes,
    scales), chunked hists) as ``key.tuple{i}``."""
    for key, val in state.items():
        if isinstance(val, tuple):
            for i, item in enumerate(val):
                yield f"{key}.tuple{i}", item
        else:
            yield key, val


def _flatten(state: dict) -> dict:
    return {name: _host(val) for name, val in _items(state)}


def _regroup(flat: dict) -> dict:
    """The inverse of :func:`_items`: ``key.tuple{i}`` leaves back into
    tuples."""
    state: dict = {}
    tuples: dict = {}
    for key, val in flat.items():
        if ".tuple" in key:
            base, idx = key.rsplit(".tuple", 1)
            tuples.setdefault(base, {})[int(idx)] = val
        else:
            state[key] = val
    for base, items in tuples.items():
        state[base] = tuple(items[i] for i in sorted(items))
    return state


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == _BF16_RECORD:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unflatten(flat: dict, device) -> dict:
    return _regroup({key: int(val) if key in _INT_KEYS and val.ndim == 0 else _tensor(val, device)
                     for key, val in flat.items()})


def save_state(path: str, state: dict) -> None:
    """Serialize a convolver state dict to an .npz file (``neojax``'s layout)."""
    np.savez(path, **_flatten(state))


def load_state(path: str, device=None) -> dict:
    """Load an .npz state onto ``device`` (None: the card): tensors in the
    file's dtypes (``|V2`` records as bfloat16), the positions as ints."""
    device = resolve_device(device)
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files}, device)


def _dcp_dict(state: dict, rank: int) -> dict:
    """A state as ``torch.distributed.checkpoint``'s flat dict: the names of
    :func:`_items` tagged with the rank, so every rank's shard is its own
    entry; ints stay ints."""
    return {f"{name}__r{rank}": val for name, val in _items(state)}


def _dcp_rank() -> tuple[int, bool]:
    """(this rank, whether there is no process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), False
    return 0, True


def save_state_dcp(path: str, state: dict) -> None:
    """Checkpoint a stream state with ``torch.distributed.checkpoint`` into
    the directory ``path`` — the counterpart of ``neojax``'s
    ``save_state_orbax``. In a process group every rank calls it with its
    own state shard (a collective call); each rank's entries are keyed by
    its rank. Works in a single process too."""
    import torch.distributed.checkpoint as dcp

    rank, no_dist = _dcp_rank()
    dcp.save(_dcp_dict(state, rank), checkpoint_id=path, no_dist=no_dist)


def load_state_dcp(path: str, like: dict) -> dict:
    """Load this rank's state from :func:`save_state_dcp`'s directory into
    tensors shaped, typed and placed like ``like`` (e.g. this rank's fresh
    state) — the counterpart of ``neojax``'s ``load_state_orbax``."""
    import torch.distributed.checkpoint as dcp

    rank, no_dist = _dcp_rank()
    flat = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in _dcp_dict(like, rank).items()}
    dcp.load(flat, checkpoint_id=path, no_dist=no_dist)
    suffix = f"__r{rank}"
    return _regroup({name[: -len(suffix)]: val for name, val in flat.items()})
