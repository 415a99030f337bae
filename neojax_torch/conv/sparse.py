"""Sparsity masks for the FDL filter (``neojax.conv.sparse``).

The predicate ``(row, col, value) -> bool`` of the reference's CSR
construction (``src/neo/container/csr_matrix.hpp:67-98``) evaluated over a
[P, K] (or [C, P, K]) spectrum grid into a boolean keep-mask, host-side
numpy, once at filter setup.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["sparsity_mask"]


def sparsity_mask(partitions: np.ndarray, predicate: Callable) -> np.ndarray:
    """Evaluate ``predicate(row, col, value) -> bool`` over a [P, K] (or
    [C, P, K]) complex spectrum grid, vectorized."""
    partitions = np.asarray(partitions)
    p, k = partitions.shape[-2], partitions.shape[-1]
    rows = np.broadcast_to(np.arange(p, dtype=np.int32)[:, None], partitions.shape)
    cols = np.broadcast_to(np.arange(k, dtype=np.int32)[None, :], partitions.shape)
    return np.asarray(predicate(rows, cols, partitions), dtype=bool)
