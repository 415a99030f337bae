"""Perceptual sparsity on the card: quality against throughput per
threshold.

Port of ``tools/bench_perceptual.py``. The reference plugin's use case:
an A-weighted perceptual threshold (``conv.perceptual_mask``) keeps the
low bins of every partition, a bin-structured mask that drops no whole
partition, so B3's chunk schedule can only narrow each chunk's lanes
(``kernels.sparse_mac.build_chunk_schedule(lanes=...)``). On the
production configuration (64 channels, a 10 s room-like IR, block 512,
P = 960, 1875 blocks) each threshold of -40/-50/-60/-70 dB and each
storage (bf16, split) gives:

  - throughput: the CUDA-event elapsed time (host gaps included) of one
    warm ``process`` call over the 1875 blocks
    (``bench.harness.cuda_seconds``), µs a block and M
    samples/s, and the speed-up against the dense filter in the same run;
  - quality: the max-channel spectrogram RMSE of the first 4 channels x
    32 blocks (:func:`head`) against the dense output (``bench.quality.
    max_channel_rms_error``, the reference's BenchmarkTab metric), on the
    host spectrogram :func:`spectro`.

A row is ``bench_sparse_sweep``'s (``row_setup``, ``process_row``): the
fused per-block convolver on the masked filter.

The IR (:func:`room_ir`) is octave-band noise with RT60 falling from 10 s
at 20 Hz to 0.6 s at 20 kHz: the frequency-dependent decay that makes
perceptual masks bin-structured (a spectrally flat IR stays ~99 % dense
at -60 dB).

Run on the card: ``python -m neojax_torch.tools.bench_perceptual
[--out PATH] [--smoke]``. ``--smoke``: bf16 at -60 dB over 256 blocks.
Without a card it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from neojax_torch.bench import harness
from neojax_torch.bench.quality import max_channel_rms_error
from neojax_torch.conv import convolver as cv
from neojax_torch.conv.partition import uniform_partition
from neojax_torch.conv.sparse import perceptual_mask
from neojax_torch.tools import bench_sparse_sweep
from neojax_torch.tools.common import finish, note, parse

SR = 48000
BLOCK = 512
CHANNELS = 64
IR_SECONDS = 10.0
STORAGES = ["bf16", "split"]  # fast rung + the exact (f32) class
THRESHOLDS = [-40.0, -50.0, -60.0, -70.0]
NB = 1875
SMOKE = {"storages": ["bf16"], "thresholds": [-60.0], "blocks": 256}
HEAD_CH, HEAD_BLOCKS = 4, 32


def room_ir(p: int, block: int, seed: int = 0) -> np.ndarray:
    """Octave-band noise IR with RT60 from 10 s (20 Hz) to 0.6 s (20 kHz)."""
    rng = np.random.default_rng(seed)
    t_len = p * block
    t = np.arange(t_len) / SR
    spec = np.fft.rfft(rng.standard_normal(t_len))
    freqs = np.fft.rfftfreq(t_len, 1 / SR)
    ir = np.zeros(t_len, np.float32)
    n_bands = 10
    for bnd in range(n_bands):
        f_lo = 20.0 * (2**bnd)
        f_hi = min(20.0 * (2 ** (bnd + 1)), SR / 2)
        rt60 = 10.0 * (0.6 / 10.0) ** (bnd / (n_bands - 1))
        band = np.zeros_like(spec)
        sel = (freqs >= f_lo) & (freqs < f_hi)
        band[sel] = spec[sel]
        ir += np.fft.irfft(band, n=t_len).astype(np.float32) * np.exp(
            -6.908 * t / rt60
        ).astype(np.float32)
    return (ir / np.abs(ir).max()).astype(np.float32)


def spectro(x):
    # Host-side numpy STFT; same frame formula as neojax_torch.fft.stft.
    x = np.asarray(x, np.float32)
    frame, tsz, hop = 1024, 2048, 512
    nf = (x.shape[-1] - frame) // hop + 1
    frames = np.stack(
        [x[:, i * hop : i * hop + frame] for i in range(nf)], axis=1
    )
    return np.fft.rfft(frames, n=tsz, axis=-1)


def partitions(block: int = BLOCK, seconds: float = IR_SECONDS) -> np.ndarray:
    """[1, P, block + 1] spectra of the room IR, P rounded up to a multiple
    of 32 (960 at the production configuration)."""
    p = -(-int(np.ceil(seconds * SR / block)) // 32) * 32
    return uniform_partition(room_ir(p, block)[None], block)


def head(out: torch.Tensor) -> np.ndarray:
    """The quality window: the first 4 channels x 32 blocks, float64."""
    return out[:HEAD_CH, : HEAD_BLOCKS * BLOCK].double().cpu().numpy()


def _timed(parts, mask, storage, sig) -> tuple[np.ndarray, float]:
    """(head of the first call from a fresh state, device seconds of one
    warm call with the state carried on)."""
    cfg, params = bench_sparse_sweep.row_setup(parts, mask, sig.shape[0], sig.device, storage)
    state = cv.init_state(cfg, sig.device)
    h = head(cv.process(cfg, params, state, sig)[1])
    return h, harness.cuda_seconds(lambda: cv.process(cfg, params, state, sig))


def sweep(storages=STORAGES, thresholds=THRESHOLDS, nb: int = NB, device="cuda") -> dict:
    parts = partitions(BLOCK, IR_SECONDS)
    gen = torch.Generator(device).manual_seed(1)
    sig = torch.rand((CHANNELS, nb * BLOCK), generator=gen, device=device).mul_(2).sub_(1)
    by_storage = {}
    for storage in storages:
        dense_head, dense_dt = _timed(parts, None, storage, sig)
        dense_sps = CHANNELS * nb * BLOCK / dense_dt
        dense_spec = spectro(dense_head)
        note(f"dense/{storage}: {1e6 * dense_dt / nb:.2f} us/block")
        points = []
        for thr in thresholds:
            mask = perceptual_mask(parts[0], SR, thr)  # [P, K] bin-structured
            h, dt = _timed(parts, mask, storage, sig)
            sps = CHANNELS * nb * BLOCK / dt
            rmse = max_channel_rms_error(dense_spec, spectro(h))
            points.append({"threshold_db": thr, "density": float(mask.mean()), "samples_per_sec": sps,
                           "us_per_block": 1e6 * dt / nb, "speedup_vs_dense": sps / dense_sps,
                           "spectrogram_rmse": rmse,
                           "spectrogram_rmse_db": 20.0 * float(np.log10(rmse)) if rmse > 0 else -200.0})
            note(f"{storage} thr {thr:.0f} dB: density {points[-1]['density']:.3f}, "
                 f"{points[-1]['us_per_block']:.2f} us/block ({points[-1]['speedup_vs_dense']:.2f}x dense)")
        by_storage[storage] = {"dense_samples_per_sec": dense_sps, "dense_us_per_block": 1e6 * dense_dt / nb,
                               "points": points}
    return {"partitions": parts.shape[1], "storages": by_storage}


def main(argv=None) -> int:
    args = parse(__doc__, argv)
    harness._require_card()
    grid = SMOKE if args.smoke else {"storages": STORAGES, "thresholds": THRESHOLDS, "blocks": NB}
    res = sweep(grid["storages"], grid["thresholds"], grid["blocks"])
    finish({"metric": "perceptual_sparsity_sweep_64ch_10s_room_ir_block512", "card": harness.card_line(),
            "smoke": args.smoke,
            "config": {"block": BLOCK, "channels": CHANNELS, "partitions": res["partitions"],
                       "blocks": grid["blocks"], "quality_window": [HEAD_CH, HEAD_BLOCKS],
                       "protocol": "CUDA-event elapsed time of one warm process call, host gaps included (min of 3) / blocks"},
            "storages": res["storages"]}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
