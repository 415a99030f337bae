"""The least bytes of one launch of B5, the nested engine's meta-partition
MAC, counted from its function and not from the kernel, so that no
implementation can read above 100 % of it.

One launch computes, for one ring position, ``acc[c, k, m] = sum_p2
dq(x[p2, c, k, m]) * filt[p2, k, m]`` over the whole meta ring. Bytes
(nothing else is counted):

- the meta ring ``[2, P2, C, K, 2S]`` read once, at its storage's
  precision;
- its float32 dynamic scales read once (the int storages: int8 keeps one a
  4 meta-bins, int16 one a meta row);
- the ring-rotated float32 filter's two planes ``[C', P2, K, 2S]`` read
  once, C' = 1 for a filter that every channel shares and C with
  ``ir.per_channel``;
- the two float32 accumulator planes ``[C, K, 2S]`` written once.

P2 = ceil(ring_partitions / chunk_blocks), C = channels, K = block + 1 and
2S = 2 * chunk_blocks come from the configuration.

Frozen with the benchmark, as ``work.py`` is: later changes to the program
do not move it.
"""

from __future__ import annotations

from benchmark.lib.work import SAMPLE_BYTES

__all__ = ["least_bytes_per_launch"]


def _scales_per_row(storage: str, row: int) -> int:
    """Float32 scales a meta row of ``row`` meta-bins carries: int8 one a 4
    meta-bins, int16 one a row, the float storages none."""
    return {"int8": -(-row // 4), "int16": 1}.get(storage, 0)


def least_bytes_per_launch(config: dict) -> int:
    """Least bytes one B5 launch at ``config`` moves."""
    storage, s = config["storage"], config["chunk_blocks"]
    p2 = -(-config["ring_partitions"] // s)
    c, k, row = config["channels"], config["block"] + 1, 2 * s
    ring = 2 * p2 * c * k * row * SAMPLE_BYTES[storage]
    scales = p2 * c * k * _scales_per_row(storage, row) * 4
    filt = 2 * (c if config.get("ir", {}).get("per_channel") else 1) * p2 * k * row * 4
    acc = 2 * c * k * row * 4
    return ring + scales + filt + acc
