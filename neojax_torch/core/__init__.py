"""neojax_torch.core — integer sizing helpers."""

from neojax_torch.core.bits import bit_ceil, idiv, is_pow2

__all__ = ["bit_ceil", "idiv", "is_pow2"]
