"""Statistics and error metrics (``neojax.ops.statistics``).

Counterparts of the reference algorithm layer (``src/neo/algorithm/mean.hpp``,
``variance.hpp``, ``standard_deviation.hpp``, ``mean_squared_error.hpp:18``,
``root_mean_squared_error.hpp:20``): the population variance (divide by N)
and, for complex input, the squared error as ``d * conj(d)``. Host input
goes to ``device`` (None: the card; ``core.device.as_tensors``).
"""

from __future__ import annotations

import torch

from neojax_torch.core.device import as_tensor, as_tensors

__all__ = [
    "mean",
    "variance",
    "standard_deviation",
    "mean_squared_error",
    "root_mean_squared_error",
]


def _mean_square(d: torch.Tensor) -> torch.Tensor:
    if d.is_complex():
        return torch.mean(torch.real(d * torch.conj(d)))
    return torch.mean(d * d)


def mean(x, device=None):
    return torch.mean(as_tensor(x, device))


def variance(x, device=None):
    """Population variance (the reference divides by N, not N-1)."""
    x = as_tensor(x, device)
    return _mean_square(x - torch.mean(x))


def standard_deviation(x, device=None):
    return torch.sqrt(variance(x, device))


def mean_squared_error(x, y, device=None):
    x, y = as_tensors(x, y, device=device)
    return _mean_square(x - y)


def root_mean_squared_error(x, y, device=None):
    return torch.sqrt(mean_squared_error(x, y, device))
