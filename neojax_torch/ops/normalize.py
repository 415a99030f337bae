"""Energy / peak normalization (``neojax.ops.normalize``).

Counterparts of ``src/neo/algorithm/normalize_energy.hpp:19,47``,
``normalize_peak.hpp:21,56`` and the multichannel
``src/neo/convolution/normalize_impulse.hpp:12-33``: a multichannel IR is
scaled by the *minimum* per-channel energy factor, so no channel exceeds
unit energy.

The energy normalizers are filter prep, beside ``conv.uniform_partition``:
a host array is normalized on the host. The peak normalizers are array
functions: host input goes to ``device`` (None: the card,
``core.device.as_tensor``).
"""

from __future__ import annotations

import torch

from neojax_torch.core.device import as_tensor

__all__ = [
    "normalize_energy_factor",
    "normalize_energy",
    "normalize_peak_factor",
    "normalize_peak",
    "normalize_impulse",
]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def normalize_energy_factor(x) -> torch.Tensor:
    """1 / sqrt(sum(x^2)); 1.0 for an all-zero signal."""
    energy = torch.sum(torch.square(_as_tensor(x)))
    return torch.where(energy > 0, 1.0 / torch.sqrt(energy), torch.ones_like(energy))


def normalize_energy(x) -> torch.Tensor:
    x = _as_tensor(x)
    return x * normalize_energy_factor(x)


def normalize_peak_factor(x, device=None) -> torch.Tensor:
    """1 / max|x|; 1.0 for an all-zero signal."""
    peak = torch.max(torch.abs(as_tensor(x, device)))
    return torch.where(peak > 0, 1.0 / peak, torch.ones_like(peak))


def normalize_peak(x, device=None) -> torch.Tensor:
    x = as_tensor(x, device)
    return x * normalize_peak_factor(x)


def normalize_impulse(x) -> torch.Tensor:
    """Energy-normalize an impulse response.

    Rank 1: unit energy. Rank 2 ``[channels, samples]``: scale the whole
    matrix by the minimum factor over channels.
    """
    x = _as_tensor(x)
    if x.ndim == 1:
        return normalize_energy(x)
    if x.ndim != 2:
        raise ValueError(f"normalize_impulse expects rank 1 or 2, got {x.ndim}")
    energies = torch.sum(torch.square(x), dim=1)
    factors = torch.where(energies > 0, 1.0 / torch.sqrt(energies), torch.ones_like(energies))
    return x * torch.min(factors)
