"""SNR-vs-sparsity quality harness: the plugin's quality sweep on the port.

Port of ``neojax.bench.quality``; counterpart of the reference plugin's
in-app sweep (``extra/plugin/src/ui/BenchmarkTab.cpp:317-358,472-525``): run
a dense partitioned convolution as the reference, then for each
dynamic-range threshold run the perceptually sparsified convolution and
report the max-over-channels spectrogram RMSE (``maxChannelRMSError``,
``BenchmarkTab.cpp:80-92``), linear and in dB. The convolutions run on the
port's :class:`~neojax_torch.conv.Convolver` on ``device`` (None: the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from neojax_torch import conv
from neojax_torch.core.device import resolve_device
from neojax_torch.fft.stft import StftOptions, stft

__all__ = ["QualityPoint", "max_channel_rms_error", "sparse_quality_sweep"]


@dataclasses.dataclass(frozen=True)
class QualityPoint:
    threshold_db: float
    density: float  # fraction of filter bins kept
    rmse: float
    rmse_db: float


def max_channel_rms_error(ref_spec, test_spec) -> float:
    """Max over channels of the spectrogram RMSE (complex magnitudes)."""
    ref = np.asarray(ref_spec)
    test = np.asarray(test_spec)
    err = np.abs(ref - test) ** 2
    per_channel = np.sqrt(err.reshape(err.shape[0], -1).mean(axis=1))
    return float(per_channel.max())


def _spectrogram(x, stft_size: int) -> np.ndarray:
    opts = StftOptions(frame_size=stft_size, transform_size=2 * stft_size, overlap_size=stft_size // 2)
    return stft(x, opts).cpu().numpy()


def _normalized(c: "conv.Convolver", signal: np.ndarray):
    out = c.process(signal)
    return out / out.abs().max().clamp_min(1e-12)


def sparse_quality_sweep(
    signal: np.ndarray,
    impulse: np.ndarray,
    *,
    sample_rate: float,
    block_size: int = 4096,
    stft_size: int = 1024,
    thresholds_db=None,
    low_bins_to_keep: int = 8,
    storage: str | None = None,
    device=None,
) -> list[QualityPoint]:
    """Sweep sparsification thresholds; return RMSE-vs-density points.

    ``thresholds_db`` are *negative* dynamic ranges like the reference's
    ``-dynamicRange`` sweep over 1..90 dB; default is 10..90 in steps of 10.
    ``storage`` as :class:`~neojax_torch.conv.Convolver`'s (None: by device).
    """
    device = resolve_device(device)
    if thresholds_db is None:
        thresholds_db = [-float(d) for d in range(10, 91, 10)]

    signal = np.asarray(signal, np.float32)
    if signal.ndim == 1:
        signal = signal[None]
    impulse = np.asarray(impulse, np.float32)
    if impulse.ndim == 1:
        impulse = impulse[None]

    ir = np.asarray(conv.normalize_impulse(impulse))
    parts = conv.uniform_partition(ir, block_size)

    dense_conv = conv.make_convolver("upols", storage, device=device)
    dense_conv.filter(parts)
    dense_spec = _spectrogram(_normalized(dense_conv, signal), stft_size)

    points = []
    for thr in thresholds_db:
        mask = conv.perceptual_mask(parts, sample_rate, thr, low_bins_to_keep)
        c = conv.make_convolver("upols", storage, device=device)
        c.filter(parts, sparsity=mask)
        rmse = max_channel_rms_error(dense_spec, _spectrogram(_normalized(c, signal), stft_size))
        points.append(
            QualityPoint(
                threshold_db=float(thr),
                density=float(np.mean(mask)),
                rmse=rmse,
                rmse_db=float(20.0 * np.log10(max(rmse, 1e-12))),
            )
        )
    return points
