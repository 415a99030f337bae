"""Pink noise (power falling as 1/f, as music's long-term spectrum does) at
an RMS of 0.1 (-20 dBFS) per channel, made on the device: Gaussian noise
shaped by 1/sqrt(f) in one real FFT per channel, DC removed.

Its spectral tilt matters to the check: a storage that quantises a row of
spectra against the row's peak (int8) loses the quiet upper bins, which
white noise would hide."""

from __future__ import annotations

import torch

RMS = 0.1


def make(generator: torch.Generator, channels: int, samples: int, device) -> torch.Tensor:
    w = torch.randn((channels, samples), generator=generator, device=device, dtype=torch.float32)
    spec = torch.fft.rfft(w)
    f = torch.arange(spec.shape[-1], device=device, dtype=torch.float32)
    spec *= torch.rsqrt(f.clamp(min=1.0))
    spec[:, 0] = 0
    x = torch.fft.irfft(spec, n=samples)
    x *= RMS / x.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return x.contiguous()
