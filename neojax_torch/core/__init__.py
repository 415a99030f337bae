"""neojax_torch.core — bit/sizing helpers, device resolution, windows, units,
split-complex layout and fixed-point arithmetic."""

from neojax_torch.core import fixed_point
from neojax_torch.core.bits import bit_ceil, bit_log2, idiv, ipow, is_pow2, next_order
from neojax_torch.core.complexes import from_split, split_conj, split_mul, split_mul_add, to_split
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
    "fixed_point",
    "bit_ceil",
    "bit_log2",
    "idiv",
    "ipow",
    "is_pow2",
    "next_order",
    "resolve_device",
    "ieee_float32",
    "polar",
    "to_split",
    "from_split",
    "split_mul",
    "split_mul_add",
    "split_conj",
    "a_weighting",
    "amplitude_to_db",
    "fast_log2",
    "fast_log10",
    "hertz_to_mel",
    "mel_to_hertz",
    "mel_frequencies",
    "rfftfreq",
    "rectangular_window",
    "hann_window",
    "hamming_window",
    "make_window",
]
