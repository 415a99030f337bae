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

``neojax``'s ``*_orbax`` pair (sharded multi-host checkpoints) has its
counterpart with the distributed engines, on ``torch.distributed.checkpoint``.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.device import resolve_device

__all__ = ["save_state", "load_state"]

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


def _flatten(state: dict) -> dict:
    flat = {}
    for key, val in state.items():
        if isinstance(val, tuple):  # quantized FDL (planes, scales), chunked hists
            for i, item in enumerate(val):
                flat[f"{key}.tuple{i}"] = _host(item)
        else:
            flat[key] = _host(val)
    return flat


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == _BF16_RECORD:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unflatten(flat: dict, device) -> dict:
    state: dict = {}
    tuples: dict = {}
    for key, val in flat.items():
        if ".tuple" in key:
            base, idx = key.rsplit(".tuple", 1)
            tuples.setdefault(base, {})[int(idx)] = _tensor(val, device)
        elif key in _INT_KEYS and val.ndim == 0:
            state[key] = int(val)
        else:
            state[key] = _tensor(val, device)
    for base, items in tuples.items():
        state[base] = tuple(items[i] for i in sorted(items))
    return state


def save_state(path: str, state: dict) -> None:
    """Serialize a convolver state dict to an .npz file (``neojax``'s layout)."""
    np.savez(path, **_flatten(state))


def load_state(path: str, device=None) -> dict:
    """Load an .npz state onto ``device`` (None: the card): tensors in the
    file's dtypes (``|V2`` records as bfloat16), the positions as ints."""
    device = resolve_device(device)
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files}, device)
