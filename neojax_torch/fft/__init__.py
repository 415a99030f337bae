"""neojax_torch.fft — transforms on torch.fft or as DFT products, and the
packed-DFT matrices."""

from neojax_torch.fft.api import fft, get_backend, ifft, irfft, rfft, set_backend

__all__ = ["set_backend", "get_backend", "fft", "ifft", "rfft", "irfft"]
