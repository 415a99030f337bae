"""neojax_torch.core — integer sizing helpers, device resolution and windows."""

from neojax_torch.core.bits import bit_ceil, idiv, is_pow2
from neojax_torch.core.device import resolve_device
from neojax_torch.core.windows import hamming_window, hann_window, make_window, rectangular_window

__all__ = [
    "bit_ceil",
    "idiv",
    "is_pow2",
    "resolve_device",
    "make_window",
    "rectangular_window",
    "hann_window",
    "hamming_window",
]
