"""Single-shot FFT convolution (``neojax.conv.fft_conv``).

Counterpart of ``src/neo/convolution/fft_convolver.hpp:20-93``: zero-pad
both inputs to ``bit_ceil(n + l - 1)``, rfft both, multiply bin-wise, irfft
(the reference's unnormalized inverse + 1/N scale == a normalized irfft),
crop to ``n + l - 1``.
"""

from __future__ import annotations

import torch

from neojax_torch.core.bits import bit_ceil
from neojax_torch.core.device import as_tensor
from neojax_torch.fft import api as fft_api

__all__ = ["fft_convolve"]


def fft_convolve(signal, patch, backend: str | None = None, device=None) -> torch.Tensor:
    """Full linear convolution via a pow-2-padded rfft (last axis, batched),
    on ``device`` (None: where a tensor input lies, host input on the card,
    ``core.device.as_tensor``); ``backend`` as ``fft.api``'s."""
    signal = as_tensor(signal, device)
    patch = as_tensor(patch, device)
    if signal.numel() == 0 or patch.numel() == 0:
        return torch.zeros((0,), dtype=signal.dtype, device=signal.device)

    n = signal.shape[-1]
    l = patch.shape[-1]
    out_len = n + l - 1
    size = bit_ceil(out_len)

    sig_spec = fft_api.rfft(signal, n=size, backend=backend)
    pat_spec = fft_api.rfft(patch, n=size, backend=backend)
    out = fft_api.irfft(sig_spec * pat_spec, n=size, backend=backend)
    return out[..., :out_len].to(signal.dtype)
