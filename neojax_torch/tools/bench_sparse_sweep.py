"""B3's chunk schedule over band masks of rising density, on the card.

Port of ``tools/bench_sparse_sweep.py``. The per-block convolver's
``process`` (B3, ``kernels.fused_stream``, with the mask's chunk
schedule) at bf16, P = 960, 64 channels, block 512, ``fused=True``, over
band masks keeping the first ``max(1, int(P d))`` partitions for d in
{1/30, 0.1, 0.3, 0.5, 0.7}, and dense. Each row's µs a block is the slope
between streams of 1024 and 8192 blocks (``bench.harness.
slope_seconds``: CUDA events, minimum of 3; the fixed cost of a call
cancels). The linear fit ``t(d) = f + d t_fdl`` over the masked rows and
the dense point says how much of a block is fixed cost, which no mask
removes.

Run on the card: ``python -m neojax_torch.tools.bench_sparse_sweep
[--out PATH] [--smoke]``. ``--smoke``: dense and d = 0.3, slope between
64 and 512 blocks. Without a card it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from neojax_torch.bench import harness
from neojax_torch.conv import convolver as cv
from neojax_torch.tools.common import finish, note, parse

BLOCK = 512
CHANNELS = 64
P = 960
STORAGE = "bf16"
NBS = (1024, 8192)
DENSITIES = (1.0 / 30.0, 0.1, 0.3, 0.5, 0.7)
SMOKE_NBS = (64, 512)
SMOKE_DENSITIES = (0.3,)


def make_parts(p: int = P, block: int = BLOCK) -> np.ndarray:
    """The tool's random filter spectra [1, p, block + 1] (seed 0)."""
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((1, p, block + 1)) + 1j * rng.standard_normal((1, p, block + 1))) * 0.05
            ).astype(np.complex64)


def band_mask(p: int, bins: int, d: float) -> np.ndarray:
    """[p, bins] keep-mask of the first ``max(1, int(p d))`` partitions."""
    mask = np.zeros((p, bins), bool)
    mask[: max(1, int(p * d))] = True
    return mask


def row_setup(parts: np.ndarray, mask, channels: int, device, storage: str = STORAGE):
    """(config, params) of one row: the fused per-block convolver on
    ``parts`` with ``mask`` (None: dense)."""
    cfg = cv.PartitionedConfig(parts.shape[-1] - 1, parts.shape[1], channels, storage=storage,
                               mac_backend="pallas", fused=True)
    return cfg, cv.filter_params(cfg, parts, sparsity=mask, device=device)


def process_row(parts: np.ndarray, mask, sig: torch.Tensor, storage: str = STORAGE) -> torch.Tensor:
    """One row's output: ``process`` of ``sig`` [C, T] from a fresh state,
    on ``sig``'s device."""
    cfg, params = row_setup(parts, mask, sig.shape[0], sig.device, storage)
    return cv.process(cfg, params, cv.init_state(cfg, sig.device), sig)[1]


def time_row(parts: np.ndarray, mask, sigs: dict, nbs) -> float:
    """µs a block of one row: the slope of ``process`` between the two
    stream lengths of ``sigs`` (card tensors), the state carried on."""
    dev = sigs[nbs[0]].device
    cfg, params = row_setup(parts, mask, CHANNELS, dev)
    state = cv.init_state(cfg, dev)
    return 1e6 * harness.slope_seconds(lambda nb: cv.process(cfg, params, state, sigs[nb]), nbs)


def linear_fit(xs, ys) -> dict:
    """Least-squares ``t(d) = f + d t_fdl`` over (density, µs) points."""
    a = np.polyfit(xs, ys, 1)
    resid = float(np.max(np.abs(np.polyval(a, xs) - np.asarray(ys))))
    return {"fixed_us": float(a[1]), "fdl_us_at_dense": float(a[0]), "max_fit_residual_us": resid}


def sweep(densities=DENSITIES, nbs=NBS, device="cuda") -> dict:
    parts = make_parts(P, BLOCK)
    gen = torch.Generator(device).manual_seed(1)
    full = torch.rand((CHANNELS, nbs[1] * BLOCK), generator=gen, device=device).mul_(2).sub_(1)
    sigs = {nbs[1]: full, nbs[0]: full[:, : nbs[0] * BLOCK].contiguous()}
    rows = {}
    dense_us = time_row(parts, None, sigs, nbs)
    rows["dense"] = {"density": 1.0, "us_per_block": dense_us, "samples_per_sec": CHANNELS * BLOCK / dense_us * 1e6}
    note(f"dense: {dense_us:.2f} us/block")
    xs, ys = [], []
    for d in densities:
        mask = band_mask(P, BLOCK + 1, d)
        us = time_row(parts, mask, sigs, nbs)
        kept = max(1, int(P * d)) / P
        key = f"density_{d:.3f}" if d < 0.1 else f"density_{d:.1f}"
        rows[key] = {"density": kept, "us_per_block": us, "samples_per_sec": CHANNELS * BLOCK / us * 1e6,
                     "speedup_vs_dense": dense_us / us}
        xs.append(kept)
        ys.append(us)
        note(f"d={d:.3f}: {us:.2f} us/block ({dense_us / us:.2f}x dense)")
        torch.cuda.empty_cache()
    fit = linear_fit(xs + [1.0], ys + [dense_us]) if xs else None
    return {"rows": rows, "linear_fit": fit}


def main(argv=None) -> int:
    args = parse(__doc__, argv)
    harness._require_card()
    nbs, dens = (SMOKE_NBS, SMOKE_DENSITIES) if args.smoke else (NBS, DENSITIES)
    res = sweep(dens, nbs)
    finish({"metric": "fused_sparse_density_sweep", "card": harness.card_line(), "smoke": args.smoke,
            "config": {"block": BLOCK, "channels": CHANNELS, "partitions": P, "storage": STORAGE,
                       "mask": "first-fraction-of-partitions band", "slope_blocks": list(nbs),
                       "protocol": "slope-timed (two stream lengths; CUDA events, min of 3)"},
            **res}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
