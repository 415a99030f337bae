"""Arbitrary-size DFT via Bluestein's chirp-z algorithm
(``neojax.fft.bluestein``).

Counterpart of ``src/neo/fft/fallback/fallback_dft_plan.hpp:24,47-78``:
chirp pre-multiply, circular convolution through a ``bit_ceil(2N+1)``-point
FFT (``torch.fft``: cuFFT on the card), chirp post-multiply. Like the
reference plan, both directions are *unnormalized* (the caller applies 1/N
for a backward transform). The chirp tables are built in numpy exactly as
``neojax`` builds them.

Also the naive O(N^2) DFT (``src/neo/fft/dft.hpp:36-59``), the test oracle:
a complex64 product, pinned to IEEE float32 (``core.device.ieee_float32``)
since cuBLAS's complex GEMM takes TF32 when the caller's flags allow it.
Host input goes to ``device`` (None: the card, ``core.device.as_tensor``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch.core.bits import bit_ceil
from neojax_torch.core.device import as_tensor, ieee_float32

__all__ = ["dft", "naive_dft"]


@functools.lru_cache(maxsize=64)
def _chirp_np(n: int, forward: bool):
    i = np.arange(n)
    j = (i * i) % (2 * n)
    sign = -1.0 if forward else 1.0
    w = np.exp(1j * sign * np.pi * j / n).astype(np.complex64)
    m = bit_ceil(2 * n + 1)
    b = np.zeros(m, dtype=np.complex64)
    b[0] = w[0]
    b[1:n] = np.conj(w[1:n])
    b[m - n + 1 :] = np.conj(w[1:n])[::-1]
    bf = np.fft.fft(b).astype(np.complex64)
    return w, bf, m


def _complex(x, device) -> torch.Tensor:
    x = as_tensor(x, device)
    return x if x.is_complex() else x.to(torch.complex64)


def dft(x, forward: bool = True, device=None) -> torch.Tensor:
    """Unnormalized DFT of arbitrary size along the last axis."""
    x = _complex(x, device)
    n = x.shape[-1]
    w, bf, m = _chirp_np(n, forward)
    w = torch.from_numpy(w).to(x.device)
    bf = torch.from_numpy(bf).to(x.device)
    a = F.pad(x * w, (0, m - n))
    conv = torch.fft.ifft(torch.fft.fft(a, dim=-1) * bf, dim=-1)
    return (conv[..., :n] * w).to(x.dtype)


def naive_dft(x, forward: bool = True, device=None) -> torch.Tensor:
    """O(N^2) matrix DFT — the cross-implementation test oracle."""
    x = _complex(x, device)
    n = x.shape[-1]
    i = np.arange(n)
    sign = -2j if forward else 2j
    mat = np.exp(sign * np.pi * np.outer(i, i) / n).astype(np.complex64)
    with ieee_float32():
        return x @ torch.from_numpy(mat).to(device=x.device, dtype=x.dtype)
