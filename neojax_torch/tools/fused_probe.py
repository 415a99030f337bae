"""Where B3's block time goes: its fixed path taken apart on the card
(64 channels, block 512).

Port of ``tools/fused_probe.py``. Rows, each in µs a block:

  ``empty_grid``                  T2 ``empty``: B3's grid writing zeros
  ``win_fwd/{float32,bfloat16}``  T2 ``win_fwd``: + frame load and forward DFT
  ``win_fwd_inv/{...}``           T2 ``win_fwd_inv``: + B3's tail-half inverse
  ``b3_zero_sched/{bf16,split}/P{32,960}``  B3 with an all-zero chunk schedule
                                  (every flag 0): the whole fixed path —
                                  window, forward DFT, quantize and ring
                                  insert, DC/Nyquist fix, inverse — without
                                  the MAC (the row the TPU tool names but
                                  never ran)
  ``b3/{bf16,split}/P{32,960}``   B3 dense (the kernel wrapper, same inputs)
  ``stream/{bf16,split}/P{32,960}`` the per-block convolver's ``process``

The matrix dtype follows the storage (f32 for split, bf16 for bf16). So for
a storage and P, B3's block splits into empty, window + forward
(``win_fwd`` - ``empty``), inverse (``win_fwd_inv`` - ``win_fwd``),
quantize/insert and fix (``b3_zero_sched`` - ``win_fwd_inv``) and MAC
(``b3`` - ``b3_zero_sched``). The TPU tool's chunk-size ladder has no
counterpart: the CUDA B3 has no DMA chunks to size.

Every row is slope-timed over two stream lengths (CUDA events, minimum of
3; a fixed per-call cost cancels); the TPU tool divided one wall time by
the block count. The JSON carries the card's name and power limit.

Run on the card: ``python -m neojax_torch.tools.fused_probe [--out path]``.
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
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.kernels.fused_step import MATRIX_DTYPES, fused_stream
from neojax_torch.kernels.probes import probe_stream

DEVICE = "cuda"  # the tool measures on the card
B, C = headline.BLOCK, headline.CHANNELS
N = 2 * B
BLOCKS = (64, 512)
_MAT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sigpads(blocks, seed: int = 0) -> dict:
    gen = torch.Generator(DEVICE).manual_seed(seed)
    full = torch.rand((C, (max(blocks) + 1) * B), generator=gen, device=DEVICE).mul_(2).sub_(1)
    return {nb: full[:, : (nb + 1) * B].contiguous() for nb in blocks}


def probe_row(mode: str, mat: str = "float32", blocks: tuple[int, int] = BLOCKS) -> float:
    """T2 in ``mode`` with ``mat`` matrices: µs a block."""
    cs, abt = mb.packed_stream_mats(N, _MAT[mat], DEVICE)
    sigpads = _sigpads(blocks)
    return 1e6 * harness.slope_seconds(lambda nb: probe_stream(sigpads[nb], cs, abt, mode), blocks)


def b3_row(storage: str, p: int, blocks: tuple[int, int] = BLOCKS, zero_sched: bool = False) -> float:
    """B3 (``fused_stream``) on the headline filter's params and a zero
    ring, from position 0, dense or with an all-zero chunk schedule: µs a
    block."""
    cfg = cv.PartitionedConfig(B, p, C, storage=storage, fused=True)
    params = cv.filter_params(cfg, headline.make_parts(p, cfg.num_bins), device=DEVICE)
    fdl = cv.init_state(cfg, device=DEVICE)["fdl"]
    planes, scales = (fdl[0], fdl[1][..., 0]) if isinstance(fdl, tuple) else (fdl, None)
    cs, abt = mb.packed_stream_mats(N, MATRIX_DTYPES[planes.dtype], DEVICE)
    sigpads = _sigpads(blocks)
    dcfix = torch.zeros((max(blocks), 2, C), dtype=torch.float32, device=DEVICE)
    sched = None
    if zero_sched:
        z = torch.zeros((p, 1), dtype=torch.int32, device=DEVICE)
        sched = (z, z.clone())

    def run(nb):
        fused_stream(sigpads[nb], planes, params["filt_rim"], 0, dcfix[:nb], cs, abt, scales, sched)

    return 1e6 * harness.slope_seconds(run, blocks)


def stream_row(storage: str, p: int, blocks: tuple[int, int] = BLOCKS) -> float:
    """The per-block convolver's ``process`` over the headline signal: µs a
    block."""
    cfg = cv.PartitionedConfig(B, p, C, storage=storage, fused=True)
    params = cv.filter_params(cfg, headline.make_parts(p, cfg.num_bins), device=DEVICE)
    state = cv.init_state(cfg, device=DEVICE)
    sigs = {nb: headline.signal(nb, DEVICE) for nb in blocks}
    return 1e6 * harness.slope_seconds(lambda nb: cv.process(cfg, params, state, sigs[nb]), blocks)


def rows(blocks: tuple[int, int] = BLOCKS) -> dict:
    """Every row of the tool, µs a block."""
    out = {"empty_grid": probe_row("empty", blocks=blocks)}
    for mode in ("win_fwd", "win_fwd_inv"):
        for mat in _MAT:
            out[f"{mode}/{mat}"] = probe_row(mode, mat, blocks)
    for storage in ("bf16", "split"):
        for p in (32, 960):
            out[f"b3_zero_sched/{storage}/P{p}"] = b3_row(storage, p, blocks, zero_sched=True)
            out[f"b3/{storage}/P{p}"] = b3_row(storage, p, blocks)
            out[f"stream/{storage}/P{p}"] = stream_row(storage, p, blocks)
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the JSON here too (a path the caller chooses)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_probe: no CUDA device; this tool measures on the card", file=sys.stderr)
        return 2
    out = {"metric": "fused_fixed_cost_probe", "unit": "us_per_block", "card": torch.cuda.get_device_name(0),
           "nvidia_smi": harness.card_line(), "channels": C, "block": B, "blocks": list(BLOCKS),
           "protocol": "slope-timed (two stream lengths; CUDA events, min of 3)", "rows": rows()}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
