"""Carry convolver params and streaming state between ``neojax`` and this
package.

Both packages use the same dict keys and shapes, so the conversion is a
dtype/device move plus three layout differences:

- ``filt_rim8 [8, 2P, 2B]`` (the JAX package's eight pre-shifted copies of
  the shared fused filter, a TPU alignment workaround) becomes
  ``filt_rim [2P, 1, 2B]``: copy 0, rows ``[:2P]``;
- the ``sp_*`` sparse-schedule tables are dropped (the kernels here run a
  dense schedule over the zeroed bins; ``mask`` is kept);
- ``state["pos"]`` is a Python int here.

Inputs are numpy arrays (``np.asarray`` of the JAX arrays). bfloat16 arrays
may arrive as numpy's ``bfloat16`` extension dtype or as float32 holding
bf16 values; :func:`state_to_numpy` returns bf16 planes as float32 (an exact
widening), so it needs no bfloat16 numpy type.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv.convolver import PartitionedConfig

__all__ = ["params_from_neojax", "state_from_neojax", "state_to_numpy"]


def _tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # the JAX package's extension dtype
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_neojax(config: PartitionedConfig, params_np: dict, device=None) -> dict:
    """neojax ``filter_params`` output (as numpy) -> this package's params."""
    params = {}
    for key, value in params_np.items():
        if key.startswith("sp_"):
            continue
        if key == "filt_rim8":
            p2 = 2 * config.num_partitions
            rim = np.asarray(value)[0, :p2][:, None, :]  # [2P, 1, 2B]
            params["filt_rim"] = _tensor(rim, device)
        else:
            params[key] = _tensor(value, device)
    return params


def state_from_neojax(config: PartitionedConfig, state_np: dict, device=None) -> dict:
    """neojax ``init_state``/``step``/``process`` state (as numpy) -> this
    package's state on ``device``."""
    storage_dt = fdl_lib.STORAGE_DTYPES[config.storage]
    state = {}
    for key, value in state_np.items():
        if key == "pos":
            state["pos"] = int(np.asarray(value))
        elif key == "fdl" and isinstance(value, (tuple, list)):
            planes, scales = value
            state["fdl"] = (_tensor(planes, device, storage_dt), _tensor(scales, device, torch.float32))
        elif key == "fdl":
            state["fdl"] = _tensor(value, device, storage_dt)
        else:
            state[key] = _tensor(value, device, torch.float32)
    return state


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def state_to_numpy(state: dict) -> dict:
    """This package's state -> numpy arrays with the JAX package's layout
    (``pos`` as an int32 scalar, bf16 planes widened to float32)."""
    out = {}
    for key, value in state.items():
        if key == "pos":
            out["pos"] = np.int32(value)
        elif isinstance(value, tuple):
            out[key] = tuple(_numpy(v) for v in value)
        else:
            out[key] = _numpy(value)
    return out
