"""Where the nested engine's int8 SNR comes from, on the card: storage x
transform precision x int8 group count x MAC backend.

Port of ``tools/int8_sweep.py``. The nested engine (``conv.nested.
process_nested``) at the headline configuration (64 channels, the 10 s
decaying-noise IR of ``bench.headline``: 938 partitions, block 512,
S = 128 blocks a chunk, 1280 blocks), each row's SNR over blocks
1152-1167 of 4 channels against the float64 oracle
(``bench.headline.oracle_head``). A row patches ``nested._QUANT_GROUPS``
(the int8 group count G) and ``nested._fft_precisions`` (the transform
precision, ``fft.matmul_backend.PRECISIONS``), as the JAX tool does, and
restores both afterwards. ``"pallas"`` runs B5 (``kernels.nested_mac``),
``"xla"`` the plain tensor ops.

On the card ``"high"`` and ``"highest"`` are the same float32 FFT
(``conv.nested._fft_precisions``), so the rows that differ only there
must come out bit-equal: the JSON names each such pair
(``same_arithmetic_as``) with its ``bit_equal`` flag, and the tool fails
if one differs. Each row's ``us_per_block`` is the CUDA-event elapsed
time (host gaps included) of one warm call (``bench.harness.cuda_seconds``)
over its blocks.

Run on the card: ``python -m neojax_torch.tools.int8_sweep [--out PATH]
[--smoke]``. ``--smoke``: the shipped row (int8, HIGH, G = 64, B5) and its
plain twin, gated at the int8 class (46 dB), its G = 16 sibling, and
split at HIGHEST, gated at the split class (90 dB); G = 16 is printed,
not gated. Without a card it raises.
"""

from __future__ import annotations

import hashlib
import sys

import torch

from neojax_torch.bench import harness, headline
from neojax_torch.conv import convolver as cv
from neojax_torch.conv import nested
from neojax_torch.tools.common import finish, note, parse

S = 128
NB = -(-(headline.SNR_START + headline.SNR_BLOCKS) // S) * S  # 1280 blocks
# (name, storage, transform precision, int8 groups, MAC backend)
GRID = (
    ("int8/default/G16/pallas", "int8", "default", 16, "pallas"),
    ("int8/default/G16/xla", "int8", "default", 16, "xla"),
    ("int8/high/G16/xla", "int8", "high", 16, "xla"),
    ("int8/high/G16/pallas", "int8", "high", 16, "pallas"),
    ("int8/high/G32/xla", "int8", "high", 32, "xla"),
    ("int8/highest/G32/xla", "int8", "highest", 32, "xla"),
    ("int8/highest/G64/xla", "int8", "highest", 64, "xla"),
    # the shipped configuration (nested._QUANT_GROUPS int8 = 64, HIGH, B5)
    # and its plain twin
    ("int8/high/G64/xla", "int8", "high", 64, "xla"),
    ("int8/high/G64/pallas", "int8", "high", 64, "pallas"),
    ("int16/high/-/xla", "int16", "high", 16, "xla"),
    ("bf16/default/-/xla", "bf16", "default", 16, "xla"),
    ("split/highest/-/xla", "split", "highest", 16, "xla"),
    ("split/default/-/xla", "split", "default", 16, "xla"),
)
# the smoke: the shipped row, its plain twin, B5 at G = 16 (ungated: G = 16
# sits below the int8 class at this depth) and split at HIGHEST
SMOKE = ("int8/high/G64/pallas", "int8/high/G64/xla", "int8/high/G16/pallas", "split/highest/-/xla")
# the storage classes of bench.py:319, gated on the smoke's rows
SMOKE_GATES_DB = {"int8/high/G64/pallas": 46.0, "int8/high/G64/xla": 46.0, "split/highest/-/xla": 90.0}


def run_row(storage: str, prec_name: str, groups: int, mac_backend: str, s: int = S, device=None,
            parts=None, sig: torch.Tensor | None = None, timed: bool = False):
    """One row: ``process_nested`` over ``sig`` [C, T] (default: the
    headline signal of NB blocks) with ``parts`` [1, P, B+1] (default: the
    headline spectra), the int8 group count and both transform precisions
    patched for the call. Returns (out [C, T], device seconds of one warm
    call or None)."""
    if prec_name not in ("default", "high", "highest"):
        raise ValueError(f"unknown precision {prec_name!r}")
    parts = headline.make_parts(headline.P_REAL, headline.BLOCK + 1) if parts is None else parts
    sig = headline.signal(NB, device) if sig is None else sig
    saved_groups, saved_prec = dict(nested._QUANT_GROUPS), nested._fft_precisions
    nested._QUANT_GROUPS["int8"] = groups
    nested._fft_precisions = lambda config: (prec_name, prec_name)
    try:
        cfg = cv.PartitionedConfig(parts.shape[-1] - 1, parts.shape[1], sig.shape[0], storage=storage,
                                   mac_backend=mac_backend)
        params = nested.nested_filter_params(cfg, parts, s, device=sig.device)
        _, out = nested.process_nested(cfg, params, nested.nested_init_state(cfg, params), sig)
        seconds = None
        if timed:
            state = nested.nested_init_state(cfg, params)
            seconds = harness.cuda_seconds(lambda: nested.process_nested(cfg, params, state, sig))
        return out, seconds
    finally:
        nested._fft_precisions = saved_prec
        nested._QUANT_GROUPS.clear()
        nested._QUANT_GROUPS.update(saved_groups)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def sweep(names=None, device="cuda") -> dict:
    """Every row named (default: the whole grid) on ``device``: SNR against
    the float64 oracle, CUDA-event µs a block, output digest, and the
    high/highest pairs."""
    by_name = {g[0]: g for g in GRID}
    names = [g[0] for g in GRID] if names is None else list(names)
    sig = headline.signal(NB, device)
    oracle = headline.oracle_head(sig)
    lo, hi = headline.SNR_START * headline.BLOCK, (headline.SNR_START + headline.SNR_BLOCKS) * headline.BLOCK
    rows = {}
    for name in names:
        _, storage, prec, groups, mac = by_name[name]
        out, sec = run_row(storage, prec, groups, mac, device=device, sig=sig, timed=True)
        snr = headline.snr_db(out[: headline.SNR_CH, lo:hi].double().cpu().numpy(), oracle)
        rows[name] = {"storage": storage, "precision": prec, "groups": groups if storage == "int8" else None,
                      "mac_backend": mac, "snr_db": snr, "us_per_block": 1e6 * sec / NB, "output_sha": _digest(out)}
        if name in SMOKE_GATES_DB:
            rows[name]["gate_db"] = SMOKE_GATES_DB[name]
        note(f"{name}: {snr:.2f} dB, {1e6 * sec / NB:.2f} us/block")
        del out
    for name, row in rows.items():  # HIGH and HIGHEST are one float32 FFT on the card
        if row["precision"] == "highest":
            twin = name.replace("/highest/", "/high/")
            if twin in rows:
                row["same_arithmetic_as"] = twin
                row["bit_equal"] = row["output_sha"] == rows[twin]["output_sha"]
    return rows


def main(argv=None) -> int:
    args = parse(__doc__, argv)
    harness._require_card()
    rows = sweep(SMOKE if args.smoke else None)
    failed = [n for n, r in rows.items() if r.get("bit_equal") is False or r["snr_db"] < r.get("gate_db", -1e9)]
    finish({"metric": "int8_snr_source_isolation", "card": harness.card_line(), "smoke": args.smoke,
            "config": {"block": headline.BLOCK, "channels": headline.CHANNELS, "partitions": headline.P_REAL,
                       "chunk_blocks": S, "blocks": NB, "snr_window_blocks": [headline.SNR_START,
                                                                              headline.SNR_BLOCKS],
                       "snr_channels": headline.SNR_CH},
            "rows": rows, "failed": failed}, args.out)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
