"""Short-time Fourier transform as a framed, batched rfft.

Port of ``neojax.fft.stft``; counterpart of ``src/neo/fft/stft.hpp:31-125``.
Frames are gathered into ``[ch, frames, transform]`` (zero-padded, the
window applied over the full transform length like the reference) and one
batched rfft (``fft.api.rfft``: pocketfft on the CPU, cuFFT on the card)
gives ``[ch, frames, bins]``. Frame count matches
``detail::num_sftf_frames``: ``ceil((signal - frame + overlap) / (frame -
overlap)) + 1``. The JAX version's ``backend`` argument (its MXU DFT
backend) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from neojax_torch.core.bits import bit_ceil, idiv
from neojax_torch.core.device import as_tensor
from neojax_torch.core.windows import make_window
from neojax_torch.fft import api as fft_api

__all__ = ["StftOptions", "num_stft_frames", "stft"]


@dataclasses.dataclass(frozen=True)
class StftOptions:
    frame_size: int
    transform_size: int
    overlap_size: int = 0
    window: Any = "hann"

    @staticmethod
    def default(transform_size: int) -> "StftOptions":
        # Matches stft_plan's convenience ctor: frame == transform, 50% overlap.
        return StftOptions(
            frame_size=transform_size,
            transform_size=transform_size,
            overlap_size=transform_size // 2,
        )


def num_stft_frames(signal_size: int, frame_size: int, overlap_size: int) -> int:
    return idiv(signal_size - frame_size + overlap_size, frame_size - overlap_size) + 1


def stft(x, options: StftOptions | int, backend: str | None = None, device=None) -> torch.Tensor:
    """STFT of ``x`` ([len] or [ch, len], a tensor or an array) ->
    [ch, frames, bins] complex. ``backend`` is ``fft.api``'s (None: the
    process default). A tensor is transformed where it lies (unless
    ``device`` is given); host data goes to ``device`` (None: the card,
    ``core.device.as_tensor``).

    Rank-1 input produces a single-channel cube with the channel axis kept,
    matching the reference's matrix-in / cube-out contract.
    """
    if isinstance(options, int):
        options = StftOptions.default(options)

    x = as_tensor(x, device)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"stft expects rank 1 or 2 input, got {x.ndim}")

    frame = options.frame_size
    overlap = options.overlap_size
    hop = frame - overlap
    if hop <= 0:
        raise ValueError("overlap_size must be < frame_size")

    # bit_ceil sizing like rfft_plan{from_order, next_order(transform_size)}
    transform = bit_ceil(options.transform_size)
    if frame > transform:
        raise ValueError("frame_size must be <= transform_size")

    frames = num_stft_frames(x.shape[1], frame, overlap)
    # Zero-pad so every frame is in bounds, then take [frames, frame]
    # windows at hop intervals.
    pad_len = (frames - 1) * hop + frame - x.shape[1]
    xp = F.pad(x, (0, max(pad_len, 0)))
    framed = xp.unfold(1, frame, hop)[:, :frames]  # [ch, frames, frame]

    # Zero-pad frames to the transform size; the window spans the full
    # transform (the reference multiplies the padded buffer by a
    # transform-length window).
    framed = F.pad(framed, (0, transform - frame))
    win = make_window(options.window, transform, dtype=framed.dtype, device=framed.device)
    return fft_api.rfft(framed * win, n=transform, backend=backend)
