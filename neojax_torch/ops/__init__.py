"""neojax_torch.ops — quantization constants and impulse normalization."""

from neojax_torch.ops.normalize import (
    normalize_energy,
    normalize_energy_factor,
    normalize_impulse,
)
from neojax_torch.ops.quantize import int_max_for

__all__ = [
    "int_max_for",
    "normalize_energy",
    "normalize_energy_factor",
    "normalize_impulse",
]
