"""Fixed-point (Q-format) arithmetic: q7 / q15 with saturating ops
(``neojax.core.fixed_point``).

Counterpart of the reference's fixed-point layer
(``src/neo/fixed_point/fixed_point.hpp:33,89-95,125-126`` and the
saturating SIMD kernels ``fixed_point/simd.hpp:28-105``): values are int8
(q7, 7 fractional bits) or int16 (q15) tensors; add/subtract saturate at
the type bounds and multiply is ``(a * b) >> frac_bits`` computed in int32
then clipped — the reference's scalar semantics per lane, bit for bit
equal to ``neojax`` on every input (``torch.round`` and ``jnp.round`` both
round half to even; ``>>`` on a signed tensor is an arithmetic shift).
Host input goes to ``device`` (None: the card, ``core.device.as_tensor``).
"""

from __future__ import annotations

import torch

from neojax_torch.core.device import as_tensor, as_tensors

__all__ = [
    "Q7",
    "Q15",
    "to_fixed",
    "to_float",
    "fixed_add",
    "fixed_subtract",
    "fixed_multiply",
]


class _QFormat:
    def __init__(self, dtype: torch.dtype, frac_bits: int):
        self.dtype = dtype
        self.frac_bits = frac_bits
        info = torch.iinfo(dtype)
        self.min = info.min
        self.max = info.max
        self.scale = float(1 << frac_bits)

    def __repr__(self):
        return f"Q{self.frac_bits}"


Q7 = _QFormat(torch.int8, 7)
Q15 = _QFormat(torch.int16, 15)


def _wide(fmt: _QFormat) -> torch.dtype:
    return torch.int16 if fmt.dtype == torch.int8 else torch.int32


def _infer(q: torch.Tensor) -> _QFormat:
    return Q7 if q.dtype == torch.int8 else Q15


def to_fixed(x, fmt: _QFormat = Q15, device=None) -> torch.Tensor:
    """float [-1, 1) -> fixed point with round-to-nearest and saturation."""
    scaled = torch.round(as_tensor(x, device, torch.float32) * fmt.scale)
    return torch.clamp(scaled, fmt.min, fmt.max).to(fmt.dtype)


def to_float(q, fmt: _QFormat | None = None, device=None) -> torch.Tensor:
    q = as_tensor(q, device)
    if fmt is None:
        fmt = _infer(q)
    return q.to(torch.float32) * (1.0 / fmt.scale)


def fixed_add(a, b, device=None) -> torch.Tensor:
    """Saturating addition (reference ``saturate(add(...))``)."""
    a, b = as_tensors(a, b, device=device)
    fmt = _infer(a)
    wide = a.to(_wide(fmt)) + b.to(_wide(fmt))
    return torch.clamp(wide, fmt.min, fmt.max).to(fmt.dtype)


def fixed_subtract(a, b, device=None) -> torch.Tensor:
    a, b = as_tensors(a, b, device=device)
    fmt = _infer(a)
    wide = a.to(_wide(fmt)) - b.to(_wide(fmt))
    return torch.clamp(wide, fmt.min, fmt.max).to(fmt.dtype)


def fixed_multiply(a, b, device=None) -> torch.Tensor:
    """Saturating Q-format multiply: (a * b) >> frac_bits in int32.

    Matches ``fixed_point.hpp:89-95``: the only value that can overflow the
    narrow type after the shift is (-1) * (-1) = +1, which saturates to max.
    """
    a, b = as_tensors(a, b, device=device)
    fmt = _infer(a)
    # int32 holds both products: q7 needs 15 bits, q15 needs 31 (2^30 max).
    prod = (a.to(torch.int32) * b.to(torch.int32)) >> fmt.frac_bits
    return torch.clamp(prod, fmt.min, fmt.max).to(fmt.dtype)
