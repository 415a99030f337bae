"""Uniform partitioning of impulse responses into FDL filter spectra
(``neojax.conv.partition``).

Counterpart of ``src/neo/convolution/uniform_partition.hpp:13-26``: an STFT
with ``frame = B``, ``transform = 2B``, ``overlap = 0`` and a rectangular
window, producing ``[ch, num_partitions, B + 1]`` complex spectra. Filter
preparation runs once at setup, host-side in numpy (the same float32 rfft
as the JAX package, so both packages start from identical spectra).
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.core.bits import idiv

__all__ = ["uniform_partition", "num_partitions"]


def num_partitions(ir_len: int, block_size: int) -> int:
    """Frame count of the partitioning STFT: ceil((len - B)/B) + 1."""
    return idiv(ir_len - block_size, block_size) + 1


def uniform_partition(impulse_response, block_size: int, backend=None) -> np.ndarray:
    """IR [len] or [ch, len] (numpy or tensor) -> partitioned spectra
    [ch, P, B+1] complex64 numpy. ``backend`` is accepted as the JAX
    package accepts it, and ignored: partitioning is a host numpy rfft."""
    if isinstance(impulse_response, torch.Tensor):
        impulse_response = impulse_response.detach().cpu().numpy()
    ir = np.asarray(impulse_response, dtype=np.float32)
    if ir.ndim == 1:
        ir = ir[None, :]
    if ir.ndim != 2:
        raise ValueError(f"impulse response must be rank 1 or 2, got {ir.ndim}")
    ch, length = ir.shape
    p = num_partitions(length, block_size)
    padded = np.zeros((ch, p * block_size), np.float32)
    padded[:, :length] = ir
    frames = padded.reshape(ch, p, block_size)
    return np.fft.rfft(frames, n=2 * block_size, axis=-1).astype(np.complex64)
