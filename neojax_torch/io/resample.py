"""Polyphase windowed-sinc sample-rate conversion for impulse responses
(``neojax.io.resample``, the same arithmetic).

The reference resamples mismatched-rate IRs to the host's audio rate before
building the convolver (``extra/plugin/src/dsp/AudioFile.cpp:22-27`` via
``AudioBuffer.cpp:11-34``, a JUCE interpolating resampler). This module is
the framework's equivalent, used at filter-prep time (the same host-side
stage as :func:`neojax_torch.conv.uniform_partition`, cf. ``partition.py``): a
rational L/M polyphase resampler with a Kaiser-windowed sinc prototype —
higher quality than the reference's interpolator, and exact for the
band-limited case.

Design: output sample j sits at input position tau = j*M/L, which for a
rational ratio takes only L distinct fractional phases p/L. The kernel
g(t) = c*sinc(c*t)*kaiser(t/H), c = min(1, L/M), is tabulated per phase
into a [L, 2H] weight bank; each output is one dot of 2H taps against a
gathered input window. All host numpy — IRs are small (seconds of audio)
and this runs once per filter load.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

__all__ = ["resample", "polyphase_weights"]


def _kaiser(x: np.ndarray, beta: float) -> np.ndarray:
    """Kaiser window on |x| <= 1 (zero outside)."""
    inside = np.abs(x) <= 1.0
    arg = np.sqrt(np.clip(1.0 - x * x, 0.0, 1.0))
    return np.where(inside, np.i0(beta * arg) / np.i0(beta), 0.0)


def polyphase_weights(up: int, down: int, half_width: int = 32, beta: float = 8.6):
    """Per-phase tap bank [up, 2*half_width] for an up/down rational ratio.

    Row p holds g(d - p/up) for tap offsets d in [-half_width+1, half_width],
    with g the Kaiser-windowed sinc cut off at min(1, up/down) of the input
    Nyquist (anti-imaging when upsampling, anti-aliasing when downsampling).
    """
    c = min(1.0, up / down)
    d = np.arange(-half_width + 1, half_width + 1, dtype=np.float64)  # [2H]
    p = np.arange(up, dtype=np.float64)[:, None] / up  # [up, 1]
    t = d[None, :] - p  # [up, 2H]
    w = c * np.sinc(c * t) * _kaiser(t / half_width, beta)
    return w.astype(np.float64)


def resample(
    x: np.ndarray,
    sr_in: int,
    sr_out: int,
    *,
    half_width: int = 32,
    beta: float = 8.6,
) -> np.ndarray:
    """Resample [..., n] samples from sr_in to sr_out Hz.

    Output length is ceil(n * sr_out / sr_in); output sample j equals the
    band-limited interpolation of the input at time j / sr_out, so the
    result is time-aligned with the input (no filter delay).
    """
    x = np.asarray(x, np.float64)
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"invalid sample rates: {sr_in} -> {sr_out}")
    if sr_in == sr_out:
        return x.astype(np.float32)
    ratio = Fraction(int(sr_out), int(sr_in))
    up, down = ratio.numerator, ratio.denominator
    n = x.shape[-1]
    n_out = -(-n * up // down)

    bank = polyphase_weights(up, down, half_width, beta)  # [up, 2H]
    u = np.arange(n_out, dtype=np.int64) * down
    base = u // up  # floor(tau)
    phase = u - base * up  # (j*down) mod up
    offs = np.arange(-half_width + 1, half_width + 1, dtype=np.int64)
    idx = base[:, None] + offs[None, :]  # [n_out, 2H]
    valid = (idx >= 0) & (idx < n)
    idx = np.clip(idx, 0, n - 1)
    taps = bank[phase] * valid  # [n_out, 2H]
    out = np.einsum("...jt,jt->...j", x[..., idx], taps)
    return out.astype(np.float32)
