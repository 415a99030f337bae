"""neojax_torch.core — integer sizing helpers, device resolution, windows and
unit conversions."""

from neojax_torch.core.bits import bit_ceil, idiv, is_pow2
from neojax_torch.core.device import ieee_float32, resolve_device
from neojax_torch.core.units import (
    a_weighting,
    amplitude_to_db,
    fast_log2,
    fast_log10,
    hertz_to_mel,
    mel_frequencies,
    mel_to_hertz,
    polar,
    rfftfreq,
)
from neojax_torch.core.windows import hamming_window, hann_window, make_window, rectangular_window

__all__ = [
    "bit_ceil",
    "idiv",
    "is_pow2",
    "resolve_device",
    "ieee_float32",
    "make_window",
    "rectangular_window",
    "hann_window",
    "hamming_window",
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
