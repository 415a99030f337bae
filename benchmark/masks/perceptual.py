"""The A-weighted perceptual mask of the upstream plugin
(``extra/plugin/src/dsp/DenseConvolution.cpp:110-166,205-267``): keep a bin
iff ``dB(power / max power) * 0.5 + weight > threshold``, the weight being
+100 dB on the lowest bins and the A-weighting at the bin's frequency
elsewhere.

Frozen copy of ``neojax_torch/conv/sparse.py`` (``perceptual_mask``,
``perceptual_weights`` and their helpers)."""

from __future__ import annotations

import numpy as np


def _amplitude_to_db(gain: np.ndarray, floor: float = -144.0) -> np.ndarray:
    out = np.full(gain.shape, floor, dtype=np.float32)
    pos = gain > 0
    np.log10(gain, out=out, where=pos)
    out[pos] = np.maximum(20.0 * out[pos], floor)
    return out


def _a_weighting(f: np.ndarray) -> np.ndarray:
    c0, c1 = 12194.217**2, 20.598997**2
    c2, c3 = 107.65265**2, 737.86223**2
    f_sq = f * f
    return 2.0 + 20.0 * (
        np.log10(c0)
        + 2.0 * np.log10(np.maximum(f_sq, 1e-30))
        - np.log10(f_sq + c0)
        - np.log10(f_sq + c1)
        - 0.5 * np.log10(f_sq + c2)
        - 0.5 * np.log10(f_sq + c3)
    )


def _weights(num_bins: int, sample_rate: float, low_bins_to_keep: int) -> np.ndarray:
    transform = 1 << ((num_bins - 1) * 2 - 1).bit_length()
    freqs = np.arange(num_bins) * (sample_rate / transform)
    weights = _a_weighting(np.maximum(freqs, 1e-12)).astype(np.float32)
    weights[:low_bins_to_keep] = 100.0
    return weights


def make(partitions: np.ndarray, config: dict) -> np.ndarray:
    spec = config["mask"]
    power = np.abs(partitions).astype(np.float32) ** 2
    max_power = np.max(power, axis=(-2, -1), keepdims=True)
    scale = np.where(max_power > 0, 1.0 / max_power, 1.0)
    weights = _weights(partitions.shape[-1], config["sample_rate"], spec["low_bins_to_keep"])
    db = _amplitude_to_db(power * scale) * 0.5 + weights
    return db > spec["threshold_db"]
