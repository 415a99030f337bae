"""Perceptual convolution demo on the card — the reference plugin's
workflow as a script (``neojax_torch``; ``examples/perceptual_convolution.py``
is the JAX package's).

Mirrors ``extra/plugin/src/PerceptualConvolution.*`` and the BenchmarkTab
quality sweep: convolve a signal with an IR densely, then at several
perceptual-sparsification thresholds (``bench.quality.
sparse_quality_sweep``), and report bins kept, spectrogram RMSE (linear
and dB) and the sweep's wall time — the quality/efficiency trade-off
curve that is the plugin's whole point.

Runs on the card; pass ``--device cpu`` for the kernels' plain versions.

Usage: python examples/perceptual_convolution_torch.py [signal.wav impulse.wav] [--device cuda]
(with no files, a synthetic two-tone signal and an exponentially decaying
noise IR).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

THRESHOLDS_DB = (-10, -20, -30, -40, -50, -60, -70, -80, -90)


def synthesize(sr: int = 48000, seconds: float = 2.0, ir_seconds: float = 1.0):
    """(signal [2, T], IR [1, L], sr): two tones in noise and decaying noise
    (seed 42), as the JAX example draws them."""
    rng = np.random.default_rng(42)
    t = np.arange(int(seconds * sr)) / sr
    sig = np.stack(
        [
            0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * rng.standard_normal(len(t)),
            0.5 * np.sin(2 * np.pi * 330 * t) + 0.2 * rng.standard_normal(len(t)),
        ]
    ).astype(np.float32)
    n_ir = int(ir_seconds * sr)
    ir = (rng.standard_normal((1, n_ir)) * np.exp(-np.arange(n_ir) / 6000)).astype(np.float32)
    return sig, ir, sr


def run(signal=None, impulse=None, sr: int = 48000, block: int = 4096, stft_size: int = 1024,
        thresholds_db=THRESHOLDS_DB, device=None) -> dict:
    """The sweep over ``thresholds_db`` of ``signal`` [C, T] with ``impulse``
    (None: :func:`synthesize`'s) on ``device`` (None: the card). Returns
    {"points": [{threshold_db, density, rmse, rmse_db}], "seconds", ...}."""
    from neojax_torch import bench

    if signal is None or impulse is None:
        signal, impulse, sr = synthesize(sr)
    t0 = time.perf_counter()
    points = bench.sparse_quality_sweep(signal, impulse, sample_rate=float(sr), block_size=block,
                                        stft_size=stft_size, thresholds_db=list(thresholds_db), device=device)
    dt = time.perf_counter() - t0
    return {"points": [{"threshold_db": p.threshold_db, "density": p.density, "rmse": p.rmse, "rmse_db": p.rmse_db}
                       for p in points],
            "seconds": dt, "signal_shape": list(np.shape(signal)), "impulse_shape": list(np.shape(impulse)),
            "sample_rate": sr, "block": block, "stft_size": stft_size}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wavs", nargs="*", help="signal.wav impulse.wav (default: synthetic)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.wavs) not in (0, 2):
        ap.error("give both signal.wav and impulse.wav, or neither")
    sig = ir = None
    sr = 48000
    if args.wavs:
        from neojax_torch.io.wav import read_wav

        sig, sr = read_wav(args.wavs[0])
        ir, _ = read_wav(args.wavs[1])
    res = run(sig, ir, sr, device=args.device)

    print(f"signal {tuple(res['signal_shape'])}, impulse {tuple(res['impulse_shape'])}, {res['sample_rate']} Hz, "
          f"block {res['block']}, device {args.device}")
    print(f"\n{'thresh dB':>10} {'bins kept':>10} {'rmse':>12} {'rmse dB':>9}")
    for p in res["points"]:
        print(f"{p['threshold_db']:>10.0f} {p['density'] * 100:>9.1f}% {p['rmse']:>12.3e} {p['rmse_db']:>9.1f}")
    print(f"\nsweep of {len(res['points'])} thresholds in {res['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
