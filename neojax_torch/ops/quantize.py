"""Reduced-precision spectrum storage: int8 / int16 / bf16
(``neojax.ops.quantize``).

Counterpart of the reference's ``compressed_fdl``
(``src/neo/convolution/compressed_fdl.hpp:17,26-48``) and
``compressed_accessor`` (``src/neo/container/compressed_accessor.hpp:16``):
values are quantized by ``round(x * int_max)`` on store (clamped to
[-int_max - 1, int_max]) and dequantized by ``x * (1 / int_max)`` on load;
bf16 is a cast. The quantized delay lines of the engines run this in
their kernels. Host input goes to ``device`` (None: the card,
``core.device.as_tensor``); dtypes are torch's or numpy's.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.device import as_tensor

__all__ = ["quantize_fixed", "dequantize_fixed", "int_max_for"]

_INT_MAX = {torch.int8: 127, torch.int16: 32767}
_FROM_NUMPY = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
               np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    np_dtype = np.dtype(dtype)
    return torch.bfloat16 if np_dtype.name == "bfloat16" else _FROM_NUMPY[np_dtype]


def int_max_for(dtype) -> int:
    return _INT_MAX[_torch_dtype(dtype)]


def quantize_fixed(x, dtype, device=None) -> torch.Tensor:
    """Quantize floats in [-1, 1] to int8/int16 at fixed full-scale."""
    x = as_tensor(x, device)
    dtype = _torch_dtype(dtype)
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16)
    m = _INT_MAX[dtype]
    scaled = torch.round(x.to(torch.float32) * m)
    return torch.clamp(scaled, -m - 1, m).to(dtype)


def dequantize_fixed(q, dtype=torch.float32, device=None) -> torch.Tensor:
    q = as_tensor(q, device)
    dtype = _torch_dtype(dtype)
    if q.dtype == torch.bfloat16:
        return q.to(dtype)
    m = _INT_MAX[q.dtype]
    return q.to(dtype) * torch.tensor(1.0 / m, dtype=dtype, device=q.device)
