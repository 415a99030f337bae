"""DCT-II via a single N-point FFT, Makhoul's even-odd permutation
(``neojax.fft.dct``).

Counterpart of ``src/neo/fft/dct.hpp:24,37-63`` (``fallback_dct2_plan``):
``v = [x0, x2, x4, ..., x5, x3, x1]``; ``X_k = Re(2 e^{-i pi k / 2N} V_k)``.
Unscaled (the factor of 2 is included, no 1/N), matching the reference.
The FFT is ``fft.api.fft`` on either backend; the twiddles are built in
float64 and rounded once to the spectrum's dtype. Host input goes to
``device`` (None: the card, ``core.device.as_tensor``).
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.device import as_tensor
from neojax_torch.fft import api as fft_api

__all__ = ["dct2"]


def dct2(x, axis: int = -1, backend: str | None = None, device=None) -> torch.Tensor:
    x = torch.movedim(as_tensor(x, device), axis, -1)
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    vf = fft_api.fft(v, n=n, backend=backend)
    phase = torch.from_numpy(np.exp(-1j * np.pi * np.arange(n) / (2.0 * n))).to(vf.device, vf.dtype)
    out = 2.0 * torch.real(vf * phase)
    return torch.movedim(out.to(x.dtype), -1, axis)
