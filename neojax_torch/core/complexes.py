"""Split-complex (planar) layout helpers (``neojax.core.complexes``).

Spectra in the kernels' layout are *split complex*: real and imaginary
planes stacked on a leading axis of size 2 (reference counterpart:
``src/neo/complex/split_complex.hpp:10`` and the split FDL/filter
variants). Interleaved ``complex64`` is the user-facing dtype; these
helpers convert at the boundary. Host input goes to ``device`` (None: the
card, ``core.device.as_tensor``); a tensor stays where it lies.
"""

from __future__ import annotations

import torch

from neojax_torch.core.device import as_tensor, as_tensors

__all__ = ["to_split", "from_split", "split_mul", "split_mul_add", "split_conj"]


def to_split(z, dtype=torch.float32, device=None) -> torch.Tensor:
    """complex [...] -> split [2, ...] (plane 0 = real, plane 1 = imag)."""
    z = as_tensor(z, device)
    im = z.imag if z.is_complex() else torch.zeros_like(z)
    return torch.stack([z.real, im]).to(dtype)


def from_split(s, dtype=torch.complex64, device=None) -> torch.Tensor:
    """split [2, ...] -> complex [...]."""
    s = as_tensor(s, device)
    return torch.complex(s[0].to(torch.float32), s[1].to(torch.float32)).to(dtype)


def split_mul(x, y, device=None) -> torch.Tensor:
    """Elementwise complex multiply in split layout: [2,...] x [2,...] -> [2,...]."""
    x, y = as_tensors(x, y, device=device)
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return torch.stack([xr * yr - xi * yi, xr * yi + xi * yr])


def split_mul_add(x, y, z, device=None) -> torch.Tensor:
    """x * y + z in split layout (the reference's hot ``multiply_add`` kernel,
    ``src/neo/algorithm/multiply_add.hpp:28-69``)."""
    x, y, z = as_tensors(x, y, z, device=device)
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return torch.stack([xr * yr - xi * yi + z[0], xr * yi + xi * yr + z[1]])


def split_conj(x, device=None) -> torch.Tensor:
    x = as_tensor(x, device)
    return torch.stack([x[0], -x[1]])
