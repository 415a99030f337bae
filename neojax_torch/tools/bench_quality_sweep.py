"""The reference plugin's quality harness over perceptual thresholds:
dense against perceptually sparsified convolution, max-channel
spectrogram RMSE per threshold.

Port of ``tools/bench_quality_sweep.py`` over ``bench.quality.
sparse_quality_sweep`` (``ui/BenchmarkTab.cpp:472-525``): 2 channels, a
2 s noise IR with exp(-3 t) decay, a 4 s uniform signal, block 1024, the
sweep's default thresholds (-10 ... -90 dB). The metric does not depend
on the hardware, so the tool takes ``--device`` (default: the card, where
the convolutions run the per-block convolver's kernels; the JAX tool ran
on the CPU only).

Run: ``python -m neojax_torch.tools.bench_quality_sweep [--out PATH]
[--smoke] [--device cuda|cpu]``. ``--smoke``: the thresholds -30 and
-60 dB. With the default device and no card it raises.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from neojax_torch.bench import harness
from neojax_torch.bench.quality import sparse_quality_sweep
from neojax_torch.tools.common import finish, parse

SR = 48000.0
IR_SECONDS = 2.0
SIG_SECONDS = 4.0
BLOCK = 1024
CHANNELS = 2
SMOKE_THRESHOLDS = [-30.0, -60.0]


def inputs(channels: int = CHANNELS, ir_seconds: float = IR_SECONDS, sig_seconds: float = SIG_SECONDS):
    """(signal [C, T], IR [C, L]) float32, as the JAX tool draws them (seed 0)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(ir_seconds * SR)) / SR
    ir = rng.standard_normal((channels, t.size)).astype(np.float32) * np.exp(-3.0 * t).astype(np.float32)
    sig = rng.uniform(-1, 1, (channels, int(sig_seconds * SR))).astype(np.float32)
    return sig, ir


def sweep(device="cuda", thresholds=None, block: int = BLOCK, **sizes) -> list[dict]:
    """The sweep's points as dicts, on ``device``."""
    sig, ir = inputs(**sizes)
    points = sparse_quality_sweep(sig, ir, sample_rate=SR, block_size=block, thresholds_db=thresholds,
                                  device=device)
    return [dataclasses.asdict(p) for p in points]


def main(argv=None) -> int:
    args = parse(__doc__, argv, device=True)
    on_card = args.device.startswith("cuda")
    if on_card:
        harness._require_card()
    points = sweep(args.device, SMOKE_THRESHOLDS if args.smoke else None)
    finish({"metric": "sparse_quality_sweep", "card": harness.card_line() if on_card else None,
            "device": args.device, "smoke": args.smoke,
            "config": {"sample_rate": SR, "ir_seconds": IR_SECONDS, "signal_seconds": SIG_SECONDS, "block": BLOCK,
                       "channels": CHANNELS,
                       "note": "reference BenchmarkTab::runSparseQualityTests parity (max-channel spectrogram "
                               "RMSE vs dense, ui/BenchmarkTab.cpp:472-525)"},
            "points": points}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
