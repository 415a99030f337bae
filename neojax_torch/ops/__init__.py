"""neojax_torch.ops — elementwise/statistics/normalization/comparison/
quantization, and the numerical-safety tools of ``ops.debug``."""

from neojax_torch.ops.compare import allclose, allmatch, default_tolerance
from neojax_torch.ops.elementwise import add, multiply, multiply_add, scale, split_multiply_add
from neojax_torch.ops.normalize import (
    normalize_energy,
    normalize_energy_factor,
    normalize_impulse,
    normalize_peak,
    normalize_peak_factor,
)
from neojax_torch.ops.quantize import dequantize_fixed, int_max_for, quantize_fixed
from neojax_torch.ops.statistics import (
    mean,
    mean_squared_error,
    root_mean_squared_error,
    standard_deviation,
    variance,
)

__all__ = [
    "add",
    "multiply",
    "multiply_add",
    "scale",
    "split_multiply_add",
    "mean",
    "variance",
    "standard_deviation",
    "mean_squared_error",
    "root_mean_squared_error",
    "normalize_energy",
    "normalize_energy_factor",
    "normalize_peak",
    "normalize_peak_factor",
    "normalize_impulse",
    "allclose",
    "allmatch",
    "default_tolerance",
    "quantize_fixed",
    "dequantize_fixed",
    "int_max_for",
]
