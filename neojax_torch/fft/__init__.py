"""neojax_torch.fft — transforms: fft/ifft/rfft/irfft, STFT, DCT-II, Bluestein
DFT, the split and packed transforms, and the packed-DFT matrices.

Backends as in ``neojax``: ``"xla"`` (and ``"auto"``: ``torch.fft``) and
``"matmul"`` (DFT products in IEEE float32). ``neojax.fft``'s four-step
route is not ported (above 8192 the ``"matmul"`` backend runs
``torch.fft``).
"""

from neojax_torch.core.bits import next_order
from neojax_torch.core.units import rfftfreq
from neojax_torch.fft.api import fft, get_backend, ifft, irfft, rfft, set_backend
from neojax_torch.fft.bluestein import dft, naive_dft
from neojax_torch.fft.dct import dct2
from neojax_torch.fft.extras import packed_irfft, packed_rfft, rfft_deinterleave, split_fft, split_ifft
from neojax_torch.fft.stft import StftOptions, num_stft_frames, stft

__all__ = [
    "fft",
    "ifft",
    "rfft",
    "irfft",
    "set_backend",
    "get_backend",
    "dft",
    "naive_dft",
    "dct2",
    "packed_rfft",
    "packed_irfft",
    "rfft_deinterleave",
    "split_fft",
    "split_ifft",
    "stft",
    "StftOptions",
    "num_stft_frames",
    "rfftfreq",
    "next_order",
]
