"""Tolerance comparison — the framework's parity gate (``neojax.ops.compare``).

Counterpart of ``src/neo/algorithm/allclose.hpp:19-44``: absolute-tolerance
comparison with the reference's documented bounds (1e-5 for float32,
1e-9 for float64 and complex128). Host operands follow a tensor operand's
device, or go to ``device`` (None: the card; ``core.device.as_tensors``).
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.device import as_tensors

__all__ = ["default_tolerance", "allclose", "allmatch"]

_F32_TOL = 1e-5
_F64_TOL = 1e-9


def default_tolerance(dtype) -> float:
    """The bound for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        wide = dtype in (torch.float64, torch.complex128)
    else:
        wide = np.dtype(dtype) in (np.dtype(np.float64), np.dtype(np.complex128))
    return _F64_TOL if wide else _F32_TOL


def allclose(x, y, tolerance: float | None = None, device=None) -> bool:
    """max |x - y| <= tolerance (absolute, like the reference; no rtol)."""
    x, y = as_tensors(x, y, device=device)
    if x.shape != y.shape:
        return False
    if tolerance is None:
        tolerance = min(default_tolerance(x.dtype), default_tolerance(y.dtype))
    return bool(torch.max(torch.abs(x - y)) <= tolerance) if x.numel() else True


def allmatch(x, y, device=None) -> bool:
    """Exact elementwise equality."""
    x, y = as_tensors(x, y, device=device)
    if x.shape != y.shape:
        return False
    return bool(torch.all(x == y)) if x.numel() else True
