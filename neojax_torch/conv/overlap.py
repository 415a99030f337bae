"""Block (un)streaming for the partitioned convolver (``neojax.conv.overlap``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["stream_blocks", "unstream_blocks"]


def stream_blocks(signal: torch.Tensor, block_size: int) -> tuple[torch.Tensor, int]:
    """Split [..., T] into [num_blocks, ..., B] (zero-padding the tail).

    Returns the block stack and the original length for later trimming.
    """
    t = signal.shape[-1]
    num_blocks = -(-t // block_size)
    padded = F.pad(signal, (0, num_blocks * block_size - t))
    stacked = padded.reshape(*signal.shape[:-1], num_blocks, block_size)
    return torch.movedim(stacked, -2, 0), t


def unstream_blocks(blocks: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of :func:`stream_blocks`: [num_blocks, ..., B] -> [..., T]."""
    joined = torch.movedim(blocks, 0, -2)
    joined = joined.reshape(*joined.shape[:-2], -1)
    return joined[..., :length]
