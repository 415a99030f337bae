"""Unit conversions: decibels, mel scale, A-weighting, FFT bin frequencies
(``neojax.core.units``).

Counterparts of:
  - ``src/neo/unit/decibel.hpp:15,28`` ``amplitude_to_db`` (accurate/estimate,
    -144 dB floor, non-positive gain maps to the floor),
  - ``src/neo/math/fast_math.hpp:12,21`` ``fast_log2``/``fast_log10``
    (bit-twiddle approximation, reproduced exactly on the int32 view),
  - ``src/neo/math/a_weighting.hpp:14-36`` IEC A-weighting curve,
  - ``src/neo/unit/mel.hpp:14,26`` mel conversions,
  - ``src/neo/fft/rfftfreq.hpp:10-27`` bin -> Hz mapping.

Tensors stay on their device; host input (numpy, lists, scalars) and the
outputs of ``mel_frequencies`` and ``rfftfreq`` go to ``device`` (None:
the card, ``core.device``).
"""

from __future__ import annotations

import torch

from neojax_torch.core.device import as_tensor, resolve_device

__all__ = [
    "polar",
    "fast_log2",
    "fast_log10",
    "amplitude_to_db",
    "a_weighting",
    "hertz_to_mel",
    "mel_to_hertz",
    "mel_frequencies",
    "rfftfreq",
]


def _floating(x, device) -> torch.Tensor:
    x = as_tensor(x, device)
    return x if x.is_floating_point() else x.to(torch.float32)


def fast_log2(x, device=None) -> torch.Tensor:
    """Bit-twiddle log2 approximation (float32), matching the reference.

    ``y = float(bits(x)) * 2^-23; m = mantissa(x) in [0.5, 1);``
    ``log2(x) ~= y - 124.2255 - 1.49803*m - 1.72588/(0.35209 + m)``

    ``bits(x)`` is the unsigned 32-bit pattern: the int32 view widened to
    int64 and masked, so negative inputs convert as the JAX package's
    uint32 view does.
    """
    x = as_tensor(x, device, torch.float32)

    def f32(v):  # float32 constants as tensors: ``v / t`` with a Python v is v * (1/t)
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    vx = x.view(torch.int32)
    mx = ((vx & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    y = (vx.to(torch.int64) & 0xFFFFFFFF).to(torch.float32) * f32(1.1920928955078125e-7)
    return y - f32(124.22551499) - f32(1.498030302) * mx - f32(1.72587999) / (f32(0.3520887068) + mx)


def fast_log10(x, device=None) -> torch.Tensor:
    out = fast_log2(x, device)
    return out * torch.tensor(0.30102999566, dtype=torch.float32, device=out.device)


def amplitude_to_db(gain, floor=-144.0, precision: str = "accurate", device=None) -> torch.Tensor:
    """20*log10(gain) clamped to ``floor``; non-positive gain -> ``floor``.

    ``precision='estimate'`` uses the bit-twiddle ``fast_log10``.
    """
    gain = _floating(gain, device)
    floor = torch.as_tensor(floor, dtype=gain.dtype, device=gain.device)
    safe = torch.where(gain > 0, gain, torch.ones_like(gain))
    if precision == "estimate":
        db = 20.0 * fast_log10(safe).to(gain.dtype)
    else:
        db = 20.0 * torch.log10(safe)
    db = torch.maximum(db, floor)
    return torch.where(gain > 0, db, floor)


def a_weighting(frequency, device=None) -> torch.Tensor:
    """A-weighting in dB at ``frequency`` Hz (> 0). IEC 61672 curve."""
    f = _floating(frequency, device)

    def sq(v):
        return torch.as_tensor(v, dtype=f.dtype, device=f.device) ** 2

    c0, c1, c2, c3 = sq(12194.217), sq(20.598997), sq(107.65265), sq(737.86223)
    f_sq = f * f
    return 2.0 + 20.0 * (
        torch.log10(c0)
        + 2.0 * torch.log10(f_sq)
        - torch.log10(f_sq + c0)
        - torch.log10(f_sq + c1)
        - 0.5 * torch.log10(f_sq + c2)
        - 0.5 * torch.log10(f_sq + c3)
    )


def hertz_to_mel(hertz, device=None) -> torch.Tensor:
    hertz = _floating(hertz, device)
    return 2595.0 * torch.log10(1.0 + hertz / 700.0)


def mel_to_hertz(mels, device=None) -> torch.Tensor:
    mels = _floating(mels, device)
    return 700.0 * (torch.pow(10.0, mels / 2595.0) - 1.0)


def mel_frequencies(n_mels: int, fmin, fmax, dtype=torch.float32, device=None) -> torch.Tensor:
    """``n_mels`` frequencies evenly spaced on the mel scale in [fmin, fmax]."""
    device = resolve_device(device)
    if n_mels == 0:
        return torch.zeros((0,), dtype=dtype, device=device)
    if n_mels == 1:
        return torch.tensor([fmin], dtype=dtype, device=device)
    min_mel = hertz_to_mel(torch.tensor(fmin, dtype=dtype, device=device))
    max_mel = hertz_to_mel(torch.tensor(fmax, dtype=dtype, device=device))
    mels = min_mel + (max_mel - min_mel) * torch.arange(n_mels, dtype=dtype, device=device) / (n_mels - 1)
    return mel_to_hertz(mels).to(dtype)


def rfftfreq(n: int, d: float = 1.0, dtype=torch.float32, device=None) -> torch.Tensor:
    """Frequencies of rFFT bins for an ``n``-point transform, spacing ``d``
    (the numpy-compatible definition; the reference's vector overload,
    ``rfftfreq.hpp:20-27``, divides by the vector length instead)."""
    return torch.arange(n // 2 + 1, dtype=dtype, device=resolve_device(device)) / (n * d)


def polar(magnitude, angle):
    """Split-complex polar -> rectangular: (mag*cos(angle), mag*sin(angle))."""
    return magnitude * torch.cos(angle), magnitude * torch.sin(angle)
