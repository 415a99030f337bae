"""The reference's partitioned-convolver benchmark grid on the card: block
4096, filters of 2^11..2^17 taps.

Port of ``tools/bench_grid.py`` (the reference's grid,
``extra/benchmark/src/convolution.cpp:42-64``). 64 channels, block 4096,
P = ceil(L / 4096) = 1..32 partitions (no padding floor, so the work
follows L), storages split and bf16, ``mac_backend="pallas"``, 512
blocks. Each row: samples/s, bytes/s (the per-block ring read at the real
P, ``2 P C B`` elements, the reference's bytes counter) and µs a block,
from the CUDA-event elapsed time (host gaps included) of one warm
``process`` call over the 512 blocks (``bench.harness.cuda_seconds``,
minimum of 2).

Route: block 4096 is above B3's ``MAX_BLOCK``, so the per-block convolver
steps block by block: cuFFT transforms (``torch.fft``) and B1
(``kernels.fdl_mac``) once a block on the packed ring [2, P, 64, 4096].
The JAX package streams this block through its four-step transform
instead (``neojax.conv.convolver._use_fourstep_stream``), to spare the
TPU's HBM the dense DFT matrices; the port keeps cuFFT (``transform``).
Before each row is timed, its B1 call is held against the plain version
on the ring and filter of the row's last block (``b1_rel_err``): one
launch of B1 a row besides the row's own, counted as every launch is
(``b1_check_launches``).

Run on the card: ``python -m neojax_torch.tools.bench_grid [--out PATH]
[--smoke]``. ``--smoke``: split at L = 2^17 over 64 blocks. Without a
card it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from neojax_torch.bench import harness
from neojax_torch.conv import convolver as cv
from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.kernels.fdl_mac import fdl_mac, fdl_mac_reference
from neojax_torch.tools.common import finish, note, parse

BLOCK = 4096
CHANNELS = 64
FILTERS = [1 << e for e in range(11, 18)]  # the reference's 2^11..2^17
NB = 512
STORAGES = ("split", "bf16")
SMOKE = {"storages": ("split",), "filters": [1 << 17], "blocks": 64}
ITEMSIZE = {"split": 4, "bf16": 2}
# max|kernel - plain| / max|plain| of B1 (chip_smoke.py's phase 3)
TOL = {"split": 2e-5, "bf16": 5e-3}


def partitions_of(length: int, block: int = BLOCK) -> int:
    return max(1, -(-length // block))


def random_parts(rng: np.random.Generator, p: int, block: int = BLOCK) -> np.ndarray:
    """[1, p, block + 1] random spectra, drawn from ``rng`` as the JAX tool
    draws them (one generator across the grid)."""
    return ((rng.standard_normal((1, p, block + 1)) + 1j * rng.standard_normal((1, p, block + 1))) * 0.05
            ).astype(np.complex64)


def row_setup(storage: str, parts: np.ndarray, channels: int, device):
    cfg = cv.PartitionedConfig(parts.shape[-1] - 1, parts.shape[1], channels, storage=storage,
                               mac_backend="pallas")
    return cfg, cv.filter_params(cfg, parts, device=device)


def process_row(storage: str, parts: np.ndarray, sig: torch.Tensor):
    """One row's stream from a fresh state on ``sig``'s device: (config,
    params, state after it, output)."""
    cfg, params = row_setup(storage, parts, sig.shape[0], sig.device)
    state, out = cv.process(cfg, params, cv.init_state(cfg, sig.device), sig)
    return cfg, params, state, out


def hold_b1(cfg, params: dict, state: dict) -> float:
    """B1 against its plain version on the ring after a stream and the
    filter its last block met: max|kernel - plain| / max|plain|."""
    p = cfg.num_partitions
    pos = (state["pos"] - 1) % p
    planes, scales = state["fdl"] if isinstance(state["fdl"], tuple) else (state["fdl"], None)
    scl = None if scales is None else scales[..., 0]
    args = (planes, fdl_lib.rotated_filter(params["filt_re"], pos, p),
            fdl_lib.rotated_filter(params["filt_im"], pos, p), scl)
    got, want = torch.cat(fdl_mac(*args)), torch.cat(fdl_mac_reference(*args))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def grid(storages=STORAGES, filters=FILTERS, nb: int = NB, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    gen = torch.Generator(device).manual_seed(0)
    sig = torch.rand((CHANNELS, nb * BLOCK), generator=gen, device=device).mul_(2).sub_(1)
    rows = {}
    for storage in storages:
        for length in filters:
            p = partitions_of(length, BLOCK)
            cfg, params, state, _ = process_row(storage, random_parts(rng, p, BLOCK), sig)
            err = hold_b1(cfg, params, state)
            if not err < TOL[storage]:
                raise AssertionError(f"B1 at [2, {p}, {CHANNELS}, {BLOCK}] ({storage}): rel err {err}")
            dt = harness.cuda_seconds(lambda: cv.process(cfg, params, state, sig), repeats=2)
            bytes_moved = nb * 2 * p * CHANNELS * BLOCK * ITEMSIZE[storage]
            rows[f"upols/{storage}/L{length}"] = {
                "samples_per_sec": CHANNELS * nb * BLOCK / dt, "bytes_per_sec": bytes_moved / dt,
                "us_per_block": 1e6 * dt / nb, "partitions": p, "ring": [2, p, CHANNELS, BLOCK],
                "b1_rel_err": err, "b1_tol": TOL[storage], "transform": "cufft"}
            note(f"upols/{storage}/L{length}: {1e6 * dt / nb:.1f} us/block (P={p})")
            del state, params
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    args = parse(__doc__, argv)
    harness._require_card()
    g = SMOKE if args.smoke else {"storages": STORAGES, "filters": FILTERS, "blocks": NB}
    rows = grid(g["storages"], g["filters"], g["blocks"])
    finish({"metric": "partitioned_conv_grid_block4096", "card": harness.card_line(), "smoke": args.smoke,
            "channels": CHANNELS, "block": BLOCK, "blocks": g["blocks"], "b1_check_launches": len(rows),
            "protocol": "CUDA-event elapsed time of one warm process call, host gaps included (min of 2) / blocks",
            "grid": rows},
           args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
