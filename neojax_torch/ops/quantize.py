"""Integer full-scale of the quantized FDL storages (``neojax.ops.quantize``)."""

from __future__ import annotations

import torch

__all__ = ["int_max_for"]

_INT_MAX = {torch.int8: 127, torch.int16: 32767}


def int_max_for(dtype: torch.dtype) -> int:
    return _INT_MAX[dtype]
