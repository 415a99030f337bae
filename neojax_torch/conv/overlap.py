"""Streaming overlap-save / overlap-add block processors and block
(un)streaming (``neojax.conv.overlap``).

Counterparts of ``src/neo/convolution/overlap_save.hpp:21-114`` and
``overlap_add.hpp:24-110``. Each processor is a pure function over an
explicit carry (the window tail / overlap tail), as in the JAX package:
``step(state, block, spectrum_fn) -> (new_state, out)``.

Transform sizing matches the reference: ``N = bit_ceil(block + filter - 1)``
(``fft::next_order``). The reference's unnormalized inverse FFT followed by
a ``1/N`` scale is equivalent to the normalized ``irfft`` used here.

All processors are batched-native: blocks are ``[channels, block]`` and the
spectrum callback sees ``[channels, bins]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from neojax_torch.core.bits import bit_ceil
from neojax_torch.core.device import resolve_device
from neojax_torch.fft import api as fft_api

__all__ = ["OverlapSave", "OverlapAdd", "stream_blocks", "unstream_blocks"]


@dataclasses.dataclass(frozen=True)
class OverlapSave:
    """Overlap-save: slide an N-window left by B, append the new block,
    rfft, apply callback to the spectrum, irfft, emit the last B samples."""

    block_size: int
    filter_size: int
    fft_backend: str | None = None

    @property
    def transform_size(self) -> int:
        return bit_ceil(self.block_size + self.filter_size - 1)

    @property
    def num_bins(self) -> int:
        return self.transform_size // 2 + 1

    def init_state(self, channels: int, dtype=torch.float32, device=None) -> torch.Tensor:
        """The carry: the window minus the incoming block (N - B samples),
        on ``device`` (None: the card)."""
        return torch.zeros((channels, self.transform_size - self.block_size), dtype=dtype,
                           device=resolve_device(device))

    def step(self, state: torch.Tensor, block: torch.Tensor, spectrum_fn: Callable):
        n = self.transform_size
        window = torch.cat([state, block.to(state.dtype)], dim=-1)  # [C, N]
        spec = fft_api.rfft(window, n=n, backend=self.fft_backend)
        spec = spectrum_fn(spec)
        y = fft_api.irfft(spec, n=n, backend=self.fft_backend)
        out = y[..., n - self.block_size :].to(block.dtype)
        return window[..., self.block_size :], out


@dataclasses.dataclass(frozen=True)
class OverlapAdd:
    """Overlap-add: zero-pad the block to N, rfft, apply callback, irfft,
    emit the first B samples plus the carried tail; carry the rest."""

    block_size: int
    filter_size: int
    fft_backend: str | None = None

    @property
    def transform_size(self) -> int:
        return bit_ceil(self.block_size + self.filter_size - 1)

    @property
    def num_bins(self) -> int:
        return self.transform_size // 2 + 1

    def init_state(self, channels: int, dtype=torch.float32, device=None) -> torch.Tensor:
        """The carry: the overlap tail (N - B samples), on ``device``
        (None: the card)."""
        return torch.zeros((channels, self.transform_size - self.block_size), dtype=dtype,
                           device=resolve_device(device))

    def step(self, state: torch.Tensor, block: torch.Tensor, spectrum_fn: Callable):
        n = self.transform_size
        b = self.block_size
        frame = F.pad(block, (0, n - b))
        spec = fft_api.rfft(frame, n=n, backend=self.fft_backend)
        spec = spectrum_fn(spec)
        y = fft_api.irfft(spec, n=n, backend=self.fft_backend)
        # Output = head of y + carried tail; new tail = shifted old tail + y's tail.
        # The tail may be shorter than a block (N - B < B); pad generically.
        tail_len = n - b
        head_overlap = F.pad(state[..., :b], (0, max(0, b - state.shape[-1])))
        out = (y[..., :b] + head_overlap).to(block.dtype)
        shifted = state[..., b:]
        shifted = F.pad(shifted, (0, tail_len - shifted.shape[-1]))
        return shifted + y[..., b:], out


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
