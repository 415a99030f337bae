"""Spectrum analysis of partitioned IRs: power image + dB histogram.

``neojax.bench.spectrum`` carried over as is (numpy only). Counterpart of
the plugin's spectrum visualization
(``extra/plugin/src/dsp/Spectrum.cpp:42-116``): a [P, K] dB power image of
the partitioned filter and a 144-bin histogram of bin levels — the preview
used to pick a perceptual sparsification threshold.
"""

from __future__ import annotations

import numpy as np

__all__ = ["power_spectrum_image", "db_histogram"]


def power_spectrum_image(partitions, floor_db: float = -144.0) -> np.ndarray:
    """Partitioned spectra [.., P, K] -> normalized dB image in [floor, 0]."""
    power = np.abs(np.asarray(partitions)) ** 2
    peak = power.max()
    scale = 1.0 / peak if peak > 0 else 1.0
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(np.maximum(power * scale, 10 ** (floor_db / 10.0)))
    return np.maximum(db, floor_db)


def db_histogram(partitions, num_bins: int = 144, floor_db: float = -144.0):
    """Histogram of bin levels in dB (1 dB buckets by default, like the
    reference's 144-bin histogram). Returns (counts, bin_edges)."""
    db = power_spectrum_image(partitions, floor_db)
    return np.histogram(db.reshape(-1), bins=num_bins, range=(floor_db, 0.0))
