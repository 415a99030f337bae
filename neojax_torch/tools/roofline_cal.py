"""Bandwidth calibration on the card, at the per-block convolver's shapes
([2, 960, 64, 512] ring, 64 channels, block 512).

Port of ``tools/roofline_cal.py``. Rows:

  ``achievable``            the read-heavy tensor-op rate
                            (``bench.harness.hbm_achievable_bytes_per_sec``)
  ``dma_only/{bf16,split}`` T1 (``kernels.probes.probe_ring_read``): B1's
                            ring read with the compute stripped, on B1's
                            grid (its ``splits``, slots ``per`` split and
                            lanes a thread ``vec``, from
                            ``fdl_mac.mac_geometry`` on the same operands),
                            chunk heads at ``choose_chunks``' geometry;
                            ``vs_mac``: its µs over B1's on the same ring
  ``mac_kernel/{bf16,split}`` B1 (``kernels.fdl_mac.fdl_mac``) proper
  ``fused_stream/{bf16,int8,split}`` the per-block convolver's ``process``
                            (B3) at P = 960, and the floor rows
                            ``fused_stream_floor/{split,bf16}/P32``

T1 and B1 take the rotated filter of the iteration's ring position (a
contiguous slice of the tiled-reversed filter), as the JAX tool does.
Every row is slope-timed: two lengths (iterations, or blocks of the
stream), per iteration = (t2 - t1) / (n2 - n1), so a fixed per-call cost
cancels; ``t`` is the minimum over repeats of a CUDA-event time. A cost
each iteration pays does not cancel: where the host's enqueue of one
iteration outlasts its kernels, the row reads the host's time. Each row
has GB/s over its bytes model (T1/B1: the ring's bytes; streams:
``bench.headline.perblock_bytes`` of the fused path, which at P = 32
counts bytes a ring resident on chip would not move — the same caveat as
the JAX tool's floor rows), µs per iteration and the share of the spec
peak; the JSON carries the card's name and power limit.

Run on the card: ``python -m neojax_torch.tools.roofline_cal [--out path]``.
Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from neojax_torch.bench import harness
from neojax_torch.bench import headline
from neojax_torch.conv import convolver as cv
from neojax_torch.kernels.fdl_mac import choose_chunks, fdl_mac
from neojax_torch.kernels.probes import probe_ring_read, ring_read_geometry

DEVICE = "cuda"  # the tool measures on the card
BLOCK, CHANNELS, P = headline.BLOCK, headline.CHANNELS, headline.P_PAD
ITERS = (64, 256)
STREAM_BLOCKS = {P: (1024, 8192), 32: (2048, 16384)}
STREAM_ROWS = (("bf16", P), ("int8", P), ("split", P), ("split", 32), ("bf16", 32))
_RING_DTYPES = {"bf16": torch.bfloat16, "split": torch.float32}


def _row(dt: float, nbytes: int, **extra) -> dict:
    peak = harness.hbm_peak_bytes_per_sec()
    gbps = nbytes / dt / 1e9
    return {"gbps": gbps, "us_per_iter": dt * 1e6, "bytes_per_iter": nbytes,
            "roofline_fraction": gbps * 1e9 / peak if peak else None, **extra}


def _ring(storage: str, seed: int = 0):
    """A random ring [2, P, C, B] in the storage dtype and a random tiled
    filter plane pair [2, 2P, B] f32, on the card."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    fdl = torch.randn((2, P, CHANNELS, BLOCK), generator=gen, device=DEVICE).to(_RING_DTYPES[storage])
    tiled = torch.randn((2, 2 * P, BLOCK), generator=gen, device=DEVICE)
    return fdl, tiled


def dma_only_row(storage: str, iters: tuple[int, int] = ITERS) -> dict:
    """T1 over ``iters`` ring positions, with its grid at position 0 (every
    position's filter slice is 16-byte aligned at K = 512, so all share it)."""
    fdl, tiled = _ring(storage)
    _, pc = choose_chunks(fdl.dtype, P, CHANNELS, BLOCK)
    s_n, per, vec = ring_read_geometry(fdl, tiled[0, P - 1 : 2 * P - 1])

    def run(n):
        for i in range(n):
            pos = i % P
            probe_ring_read(fdl, tiled[0, P - 1 - pos : 2 * P - 1 - pos], pc)

    dt = harness.slope_seconds(run, iters)
    return _row(dt, fdl.numel() * fdl.element_size(), p_chunk=pc, splits=s_n, per=per, vec=vec)


def mac_kernel_row(storage: str, iters: tuple[int, int] = ITERS) -> dict:
    """B1 over ``iters`` ring positions, shared filter."""
    fdl, tiled = _ring(storage)
    tiled = tiled[:, :, None, :].contiguous()  # [2, 2P, 1, B]

    def run(n):
        for i in range(n):
            pos = i % P
            fdl_mac(fdl, tiled[0, P - 1 - pos : 2 * P - 1 - pos], tiled[1, P - 1 - pos : 2 * P - 1 - pos])

    dt = harness.slope_seconds(run, iters)
    return _row(dt, fdl.numel() * fdl.element_size())


def ring_rows(storage: str, iters: tuple[int, int] = ITERS) -> dict:
    """``dma_only/<storage>`` (T1, with ``vs_mac``) and ``mac_kernel/<storage>`` (B1)."""
    dma, mac = dma_only_row(storage, iters), mac_kernel_row(storage, iters)
    dma["vs_mac"] = dma["us_per_iter"] / mac["us_per_iter"]
    return {f"dma_only/{storage}": dma, f"mac_kernel/{storage}": mac}


def fused_stream_row(storage: str, p: int, blocks: tuple[int, int]) -> dict:
    """The per-block convolver's ``process`` (B3) over ``blocks`` blocks of
    the headline signal, state carried across calls."""
    cfg = cv.PartitionedConfig(BLOCK, p, CHANNELS, storage=storage, fused=True)
    params = cv.filter_params(cfg, headline.make_parts(p, cfg.num_bins), device=DEVICE)
    state = cv.init_state(cfg, device=DEVICE)
    sigs = {nb: headline.signal(nb, DEVICE) for nb in blocks}

    def run(nb):
        cv.process(cfg, params, state, sigs[nb])

    dt = harness.slope_seconds(run, blocks)
    return _row(dt, headline.perblock_bytes(cfg, p, fused=True), blocks=list(blocks),
                samples_per_sec=CHANNELS * BLOCK / dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the JSON here too (a path the caller chooses)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("roofline_cal: no CUDA device; this tool measures on the card", file=sys.stderr)
        return 2
    peak = harness.hbm_peak_bytes_per_sec()
    ach = harness.hbm_achievable_bytes_per_sec()
    rows = {"spec_peak_gbps": peak / 1e9 if peak else None,
            "achievable": {"gbps": ach / 1e9, "roofline_fraction": ach / peak if peak else None}}
    for storage in ("bf16", "split"):
        rows.update(ring_rows(storage))
    for storage, p in STREAM_ROWS:
        key = f"fused_stream/{storage}" if p == P else f"fused_stream_floor/{storage}/P{p}"
        rows[key] = fused_stream_row(storage, p, STREAM_BLOCKS[p])
        torch.cuda.empty_cache()
    out = {"metric": "roofline_calibration", "card": torch.cuda.get_device_name(0),
           "nvidia_smi": harness.card_line(),
           "config": {"block": BLOCK, "channels": CHANNELS, "partitions": P},
           "protocol": "slope-timed (two lengths; CUDA events, min of 3; a fixed per-call cost cancels)",
           **rows}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
