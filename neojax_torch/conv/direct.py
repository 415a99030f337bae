"""Time-domain (direct) convolution (``neojax.conv.direct``).

Counterpart of ``src/neo/convolution/direct_convolve.hpp:16-73``: the full
linear convolution as one ``torch.nn.functional.conv1d`` (cuDNN on the
card) of the signal with the flipped patch and ``l - 1`` zeros of padding
on each side. The convolution runs in IEEE float32 whatever the caller's
TF32 flags (``core.device.ieee_float32``); float64 input stays float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neojax_torch.core.device import as_tensor, ieee_float32

__all__ = ["direct_convolve"]


def _as_input(x, device) -> torch.Tensor:
    x = as_tensor(x, device)
    return x if x.is_floating_point() or x.is_complex() else x.to(torch.float32)


def _conv_real(signal: torch.Tensor, patch: torch.Tensor) -> torch.Tensor:
    l = patch.shape[-1]
    with ieee_float32():
        out = F.conv1d(signal.reshape(1, 1, -1), patch.flip(-1).reshape(1, 1, -1), padding=l - 1)
    return out.reshape(-1)


def direct_convolve(signal, patch, device=None) -> torch.Tensor:
    """Full linear convolution of two 1-D arrays (length n + l - 1), on
    ``device``; None: where a tensor input lies, host input on the card
    (``core.device.as_tensor``)."""
    signal = _as_input(signal, device)
    patch = _as_input(patch, device)
    if signal.ndim != 1 or patch.ndim != 1:
        raise ValueError("direct_convolve expects 1-D inputs")
    if signal.numel() == 0 or patch.numel() == 0:
        return torch.zeros((0,), dtype=signal.dtype, device=signal.device)
    dtype = torch.promote_types(signal.dtype, patch.dtype)
    signal, patch = signal.to(dtype), patch.to(dtype)
    if not dtype.is_complex:
        return _conv_real(signal, patch)
    # (a + ib) * (c + id) = (ac - bd) + i(ad + bc), four real convolutions
    a, b, c, d = signal.real, signal.imag, patch.real, patch.imag
    return torch.complex(_conv_real(a, c) - _conv_real(b, d), _conv_real(a, d) + _conv_real(b, c))
