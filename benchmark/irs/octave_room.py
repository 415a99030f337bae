"""Octave-band room IR: ten octave bands of noise from 20 Hz, each decaying
with its own RT60, from 10 s in the lowest band down to 0.6 s in the top
one, normalised to a peak of 1. The frequency-dependent decay is what makes
a perceptual mask bin-structured.

Frozen copy of ``neojax_torch/tools/bench_perceptual.py::room_ir``, with the
generator passed in."""

from __future__ import annotations

import numpy as np


def make(rng: np.random.Generator, config: dict) -> np.ndarray:
    sr = config["sample_rate"]
    t_len = config["ir"]["partitions"] * config["block"]
    t = np.arange(t_len) / sr
    spec = np.fft.rfft(rng.standard_normal(t_len))
    freqs = np.fft.rfftfreq(t_len, 1 / sr)
    ir = np.zeros(t_len, np.float32)
    n_bands = 10
    for bnd in range(n_bands):
        f_lo = 20.0 * (2**bnd)
        f_hi = min(20.0 * (2 ** (bnd + 1)), sr / 2)
        rt60 = 10.0 * (0.6 / 10.0) ** (bnd / (n_bands - 1))
        band = np.zeros_like(spec)
        sel = (freqs >= f_lo) & (freqs < f_hi)
        band[sel] = spec[sel]
        ir += np.fft.irfft(band, n=t_len).astype(np.float32) * np.exp(-6.908 * t / rt60).astype(np.float32)
    return (ir / np.abs(ir).max()).astype(np.float32)
