"""neojax_torch.fft — real transforms on torch.fft and the packed-DFT builders."""

from neojax_torch.fft.api import irfft, rfft

__all__ = ["rfft", "irfft"]
