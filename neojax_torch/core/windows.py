"""Window functions (symmetric, matching the reference formulas).

Port of ``neojax.core.windows``; reference ``src/neo/math/windowing.hpp:15,29,45``:
rectangular, hann and hamming windows defined over ``n - 1`` (the symmetric
variant). Built in float64 on the host, then cast and moved once to
``device`` (None: the card, ``core.device.resolve_device``; ``"cpu"`` on
request).
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.device import resolve_device

__all__ = [
    "rectangular_window",
    "hann_window",
    "hamming_window",
    "make_window",
]


def _put(w: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(w).to(device=resolve_device(device), dtype=dtype)


def rectangular_window(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((size,), dtype=dtype, device=resolve_device(device))


def hann_window(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    if size == 1:
        return rectangular_window(1, dtype, device)
    i = np.arange(size, dtype=np.float64)
    return _put(0.5 * (1.0 - np.cos(2.0 * np.pi * i / (size - 1))), dtype, device)


def hamming_window(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    if size == 1:
        return rectangular_window(1, dtype, device)
    i = np.arange(size, dtype=np.float64)
    return _put(0.54 - 0.46 * np.cos(2.0 * np.pi * i / (size - 1)), dtype, device)


_WINDOWS = {
    "rectangular": rectangular_window,
    "boxcar": rectangular_window,
    "hann": hann_window,
    "hamming": hamming_window,
}


def make_window(name_or_array, size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Resolve a window spec (name, callable or array) to a [size] tensor on
    ``device`` (None: the card)."""
    if isinstance(name_or_array, str):
        try:
            fn = _WINDOWS[name_or_array.lower()]
        except KeyError:
            raise ValueError(f"unknown window: {name_or_array!r}") from None
        return fn(size, dtype=dtype, device=device)
    if callable(name_or_array):
        name_or_array = name_or_array(size)
    arr = torch.as_tensor(name_or_array).to(device=resolve_device(device), dtype=dtype)
    if tuple(arr.shape) != (size,):
        raise ValueError(f"window shape {tuple(arr.shape)} != ({size},)")
    return arr
