"""The headline configuration and the bytes and operations of its kernels.

Counterpart of ``bench.py:53-81`` (the IR and its partitioned spectra) and
``bench.py:228-252`` (the per-block bytes model): 64 channels, a 10 s shared
decaying-noise IR at 48 kHz (938 partitions of block 512; the per-block
convolver pads them to 960), transform N = 1024.

The per-kernel models count the work of one call at its call shape: each
input byte read once and each output byte written once (whatever the
kernel reads again), and the float32 operations of the function the
kernel computes: each DFT as a real FFT (2.5 N log2 N, half of
:func:`harness.fft_flops`), 8 a complex multiply-add of the MACs, 2 a
dequantized complex element, 3 a quantized spectrum element. The kernels
themselves compute each DFT as a dense GEMV against the packed DFT
matrices (2 N 2B operations forward and 2 2B n inverse a channel and
block, 3.1 M at N = 1024 and n = N against 51 200 for two real FFTs);
the bound counts the FFT, the least work that computes the same
function. Where the work depends on the data (a chunk or tile schedule),
the model takes the rows and lanes this call visits. :func:`bound` turns
a model into the least time on the card: the larger of bytes over the
memory rate and operations over the f32 rate.

``perblock_bytes`` is ``bench._perblock_bytes`` unchanged: the device-memory
bytes one block of the per-block convolver touches when the whole ring is
read every block (the fused kernel's schedule). The tools report their
stream rows against it, as the JAX tools do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neojax_torch.bench.harness import fft_flops
from neojax_torch.conv.nested import _QUANT_GROUPS
from neojax_torch.core.device import resolve_device

__all__ = [
    "SR",
    "BLOCK",
    "CHANNELS",
    "P_REAL",
    "P_PAD",
    "ITEMSIZE",
    "MAT_ITEMSIZE",
    "make_ir",
    "make_parts",
    "signal",
    "perblock_bytes",
    "Work",
    "bound",
    "fdl_mac_work",
    "fused_block_step_work",
    "fused_stream_work",
    "sparse_fdl_mac_work",
    "nested_mac_work",
    "ring_read_work",
    "stream_probe_work",
    "transform_work",
    "quantize_work",
    "stream_mac_work",
    "writeback_work",
    "step_mac_work",
    "step_reduce_work",
    "sched_widths_work",
    "chunked_work",
    "chunk_visits",
    "tile_live",
]

SR = 48000
BLOCK = 512
CHANNELS = 64
P_REAL = int(np.ceil(10.0 * SR / BLOCK))  # 938 partitions (10 s IR)
P_PAD = 960  # Convolver.filter's padding of 938

# bytes per ring element, and per DFT-matrix / fused-filter element
ITEMSIZE = {"split": 4, "bf16": 2, "int16": 2, "int8": 1}
MAT_ITEMSIZE = {"split": 4, "bf16": 2, "int16": 4, "int8": 2}
_QUANT = ("int16", "int8")


def make_ir(p: int | None = None, block: int | None = None) -> np.ndarray:
    """The bench IR: ``p * block`` samples of exponentially decaying noise
    (seeded), the shape of a real reverb tail."""
    p = P_REAL if p is None else p
    block = BLOCK if block is None else block
    rng = np.random.default_rng(0)
    n = p * block
    t = np.arange(n)
    return rng.standard_normal(n) * (0.05 * np.exp(-t / (n / 4)))


def make_parts(p: int, bins: int) -> np.ndarray:
    """[1, p, bins] complex64 partitioned spectra of the bench IR: the rfft
    of each (bins - 1)-sample segment zero-padded to twice its length."""
    b = bins - 1
    ir = make_ir(p, b).reshape(p, b)
    seg = np.concatenate([ir, np.zeros_like(ir)], axis=-1)
    return np.fft.rfft(seg, axis=-1)[None].astype(np.complex64)


def signal(num_blocks: int, device=None, seed: int = 1, channels: int = CHANNELS,
           block: int = BLOCK) -> torch.Tensor:
    """A seeded uniform(-1, 1) float32 test signal ``[channels, num_blocks *
    block]``, drawn on ``device`` (None: the card). ``bench.py:_signal``
    draws with JAX's threefry, so the two are not equal bit for bit; both
    are uniform noise of the same shape."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.rand((channels, num_blocks * block), generator=gen, device=dev)
    return x.mul_(2.0).sub_(1.0)


def perblock_bytes(config, p: int, fused: bool = False) -> int:
    """``bench._perblock_bytes``: device-memory bytes per block of the
    per-block step — the full FDL read + one row write, rotated filter
    planes, DFT matrices, block IO. On the fused path the matrices and the
    scale table are not counted (fetched once a stream) and the window
    reads each input sample twice."""
    lanes = config.block_size if config.use_packed else config.num_bins
    itemsize = {"dense": 8, "split": 4, "bf16": 2, "int16": 2, "int8": 1}[config.storage]
    n = config.transform_size
    fdl = 2 * p * config.channels * lanes * itemsize
    filt_item = 2 if (fused and config.storage in ("bf16", "int8")) else 4
    filt = 2 * p * lanes * filt_item
    if fused:
        mats = 0
        io = config.channels * (n + config.block_size) * 4
        scl = 0
    else:
        mats = (2 * n * lanes + 2 * lanes * n) * 4
        io = 2 * config.channels * config.block_size * 4
        scl = (2 * p * config.channels * 4) if config.storage in _QUANT else 0
    return fdl + filt + mats + io + scl


@dataclasses.dataclass(frozen=True)
class Work:
    """Device-memory bytes and float32 operations of one call."""

    bytes: int
    flops: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)


def bound(work: Work, bytes_per_sec: float, flops_per_sec: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = work.bytes / bytes_per_sec
    t_ops = work.flops / flops_per_sec
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chunk_visits(c_idx, flags, pos0: int, nb: int, pc: int, b: int) -> tuple[int, int, list[int]]:
    """What nb blocks of B2/B3 visit under the fused chunk schedule (the full
    [P, L] tables; block i reads row ``(pos0 + i) % P``, each flag-1 chunk of
    ``pc`` rows over its first ``b >> code`` lanes): (distinct ring (row,
    lane) pairs, distinct fused-filter (row, lane) pairs of the [2P] rim,
    pairs visited by each block)."""
    from neojax_torch.kernels.sparse_mac import lane_widths

    c_idx, flags = np.asarray(c_idx), np.asarray(flags)
    p = c_idx.shape[0]
    n_codes = len(lane_widths(b))
    ring = np.zeros((p, b), bool)
    filt = np.zeros((2 * p, b), bool)
    per_block = []
    for i in range(nb):
        pos = (pos0 + i) % p
        seen = np.zeros((p, b), bool)
        for v, fl in zip(c_idx[pos].tolist(), flags[pos].tolist()):
            if fl == 1:
                code = v >> 16
                cj = v & 0xFFFF
                seen[cj * pc : (cj + 1) * pc, : b >> code if code < n_codes else b] = True
        ring |= seen
        filt[p - 1 - pos : 2 * p - 1 - pos] |= seen
        per_block.append(int(seen.sum()))
    return int(ring.sum()), int(filt.sum()), per_block


def tile_live(k_idx_row, p_idx_row, flags_row, pc: int, k_tile: int, k: int) -> tuple[int, int]:
    """((row, lane) pairs, distinct rows) one row of B4's (k-tile, p-chunk)
    schedule visits."""
    pairs, rows = 0, set()
    for kt, pj, fl in zip(np.asarray(k_idx_row).tolist(), np.asarray(p_idx_row).tolist(),
                          np.asarray(flags_row).tolist()):
        if fl == 1:
            pairs += pc * (min(k, (kt + 1) * k_tile) - kt * k_tile)
            rows.update(range(pj * pc, (pj + 1) * pc))
    return pairs, len(rows)


def fdl_mac_work(storage: str, p: int, c: int, k: int, cf: int = 1) -> Work:
    """B1 ``fdl_mac``: ring [2, P, C, K], filter planes [P, cf, K] f32 x2
    (cf = 1 shared, C per channel), scales [P, C] (int storages) -> acc
    [C, K] f32 x2."""
    q = storage in _QUANT
    nbytes = 2 * p * c * k * ITEMSIZE[storage] + 2 * p * cf * k * 4 + (p * c * 4 if q else 0) + 2 * c * k * 4
    flops = 8 * p * c * k + (2 * p * c * k if q else 0)
    return Work(nbytes, flops)


def _rfft_flops(n: int) -> int:
    """One real transform of n points: half the complex FFT's 5 N log2 N."""
    return fft_flops(n) // 2


def _block_flops(storage: str, c: int, b: int, live: int) -> int:
    """One block of B2/B3 over its channels: the forward and inverse real
    FFTs of N = 2B, the MAC over ``live`` (row, lane) pairs (dequantized for
    the int storages) and the quantize of the new row."""
    q = storage in _QUANT
    return c * (2 * _rfft_flops(2 * b) + 8 * live + (2 * live + 3 * 2 * b if q else 0))


def fused_block_step_work(storage: str, p: int, c: int, b: int, live: int | None = None) -> Work:
    """B2 ``fused_block_step``, one block: frame [C, N], the ring's visited
    (row, lane) pairs (``live``; all P x B dense) and their shared filter
    values, the new row, cs [2, N, B] + ab [2, B, N], dcfix, scales -> y
    [C, N]."""
    live = p * b if live is None else live
    n = 2 * b
    it, mit = ITEMSIZE[storage], MAT_ITEMSIZE[storage]
    q = storage in _QUANT
    nbytes = (c * n * 4 + 2 * live * c * it + 2 * c * b * it + 2 * live * mit
              + 2 * 2 * n * b * mit + 2 * c * 4 + (p * c * 4 + c * 4 if q else 0) + c * n * 4)
    return Work(nbytes, _block_flops(storage, c, b, live))


def fused_stream_work(storage: str, p: int, c: int, b: int, nb: int, pos0: int = 0,
                      visits: tuple[int, int, list[int]] | None = None) -> Work:
    """B3 ``fused_stream`` over nb blocks, each input read once: sigpad
    [C, (nb+1)B], the ring's and the shared fused filter's visited (row,
    lane) pairs (``visits``, from :func:`chunk_visits`; dense: all P x B
    ring pairs and the rim rows the nb rotations from ``pos0`` reach), cs
    [N, 2B] + abt [2B, B], dcfix_all, scales -> out [C, nb B] and the
    inserted rows. A block-by-block schedule must read the ring again every
    block (the 252 MB f32 ring at the headline shape does not fit the
    card's 50 MB L2); :func:`perblock_bytes` counts that schedule's bytes."""
    if visits is None:
        rim_rows = np.zeros(2 * p, bool)
        for i in range(min(nb, p)):
            start = p - 1 - (pos0 + i) % p
            rim_rows[start : start + p] = True
        visits = (p * b, int(rim_rows.sum()) * b, [p * b] * nb)
    ring_pairs, filt_pairs, live = visits
    n = 2 * b
    it, mit = ITEMSIZE[storage], MAT_ITEMSIZE[storage]
    q = storage in _QUANT
    rows = min(nb, p)
    nbytes = (c * (nb + 1) * b * 4 + 2 * ring_pairs * c * it + 2 * rows * c * b * it
              + 2 * filt_pairs * mit + n * 2 * b * mit + 2 * b * b * mit + nb * 2 * c * 4
              + (p * c * 4 + rows * c * 4 if q else 0) + c * nb * b * 4)
    flops = sum(_block_flops(storage, c, b, lv) for lv in live)
    return Work(nbytes, flops)


def sparse_fdl_mac_work(storage: str, c: int, k: int, live: int, rows: int, cf: int = 1) -> Work:
    """B4 ``sparse_fdl_mac``: the ring's and the filter's ([P, cf, K])
    visited (row, lane) pairs (``live``, over ``rows`` distinct rows for the
    scales) -> acc [C, K] f32 x2 (unvisited lanes written 0)."""
    q = storage in _QUANT
    nbytes = 2 * live * c * ITEMSIZE[storage] + 2 * live * cf * 4 + (rows * c * 4 if q else 0) + 2 * c * k * 4
    flops = 8 * live * c + (2 * live * c if q else 0)
    return Work(nbytes, flops)


def nested_mac_work(storage: str, p2: int, c: int, k: int, l: int) -> Work:
    """B5 ``nested_mac``: planes [2, P2, C, K, L], group scales [P2, C, K, G]
    (int storages; G as the nested engine picks it), shared filter
    [P2, K, L] f32 x2 -> acc [C, K, L] f32 x2."""
    q = storage in _QUANT
    g = min(_QUANT_GROUPS[storage], l) if q else 0
    while g and l % g:
        g -= 1
    nbytes = (2 * p2 * c * k * l * ITEMSIZE[storage] + p2 * c * k * g * 4
              + 2 * p2 * k * l * 4 + 2 * c * k * l * 4)
    flops = 8 * p2 * c * k * l + (2 * p2 * c * k * l if q else 0)
    return Work(nbytes, flops)


def ring_read_work(storage: str, p: int, c: int, k: int, pc: int) -> Work:
    """T1 ``probe_ring_read``: the ring [2, P, C, K] and the filter's chunk-head
    rows [P/pc, K] f32 -> out0, out1 [C, K] f32."""
    heads = p // pc
    nbytes = 2 * p * c * k * ITEMSIZE[storage] + heads * k * 4 + 2 * c * k * 4
    flops = 2 * heads * c * k + (2 * p - heads) * c * k
    return Work(nbytes, flops)


def stream_probe_work(mat_itemsize: int, c: int, b: int, nb: int, mode: str) -> Work:
    """T2 ``probe_stream``: ``empty`` writes out [C, nb B]; ``win_fwd`` also
    reads sigpad and cs [N, 2B] and does a forward real FFT and the fold
    a channel and block; ``win_fwd_inv`` also reads abt [2B, B] and does
    the inverse FFT in place of the fold."""
    n = 2 * b
    out = c * nb * b * 4
    if mode == "empty":
        return Work(out, 0)
    nbytes = out + c * (nb + 1) * b * 4 + n * 2 * b * mat_itemsize
    if mode == "win_fwd":
        return Work(nbytes, nb * c * (_rfft_flops(n) + b))
    return Work(nbytes + 2 * b * b * mat_itemsize, nb * c * 2 * _rfft_flops(n))


# The stage kernels of B2 and B3 (``kernels.fused_step``). Each counts the
# function of its own stage: a transform as the real FFT it computes (as
# every DFT here, whatever the kernel multiplies by), the MACs as 8 a complex
# multiply-add plus 2 a dequantized history element.


def transform_work(rows: int, n: int, a_bytes: int, cols: int) -> Work:
    """``window_forward`` / ``window_inverse``: one real FFT of n = 2B points
    a row, its input read once (``a_bytes``: B3's forward reads its
    overlapping frames once, the signal window) -> out [rows, cols] f32."""
    return Work(a_bytes + rows * cols * 4, rows * _rfft_flops(n))


def quantize_work(storage: str, rows: int, b: int) -> Work:
    """``quantize_rows``: spectra [rows, 2B] f32 -> rows in the storage dtype
    (+ a scale a row for the int storages)."""
    q = storage in _QUANT
    return Work(rows * 2 * b * (4 + ITEMSIZE[storage]) + (rows * 4 if q else 0), rows * 2 * b * 3 if q else 0)


def stream_mac_work(storage: str, p: int, c: int, b: int, wc: int, cf: int = 1,
                    live: int | None = None, seed: bool = False) -> Work:
    """``stream_mac`` over a window of ``wc`` blocks: the P - 1 older ring
    rows and the window's rows with their scales, the P filter rows, dcfix
    (and the seed) -> acc [wc, C, 2B] f32. ``live``: the (tap, lane) pairs
    the blocks sum, all ``wc * P * B`` dense."""
    live = wc * p * b if live is None else live
    q = storage in _QUANT
    hist = (p - 1 + wc) * c
    nbytes = (2 * hist * b * ITEMSIZE[storage] + (hist * 4 if q else 0) + p * cf * 2 * b * MAT_ITEMSIZE[storage]
              + wc * 2 * c * 4 + (wc * 2 * c * b * 4 if seed else 0) + wc * c * 2 * b * 4)
    return Work(nbytes, 8 * live * c + (2 * 2 * hist * b if q else 0))


def writeback_work(storage: str, rows: int, c: int, b: int) -> Work:
    """``ring_writeback``: ``rows`` staged rows read and written into the ring."""
    q = storage in _QUANT
    return Work(2 * (rows * 2 * c * b * ITEMSIZE[storage] + (rows * c * 4 if q else 0)), 0)


def step_mac_work(storage: str, p: int, c: int, b: int, splits: int, cf: int = 1, live: int | None = None) -> Work:
    """``step_mac``: the ring's live (slot, lane) pairs (all P x B dense) with
    their scales and filter values -> partial sums [splits, 2, C, B] f32."""
    live = p * b if live is None else live
    q = storage in _QUANT
    nbytes = (2 * live * c * ITEMSIZE[storage] + (p * c * 4 if q else 0) + 2 * live * cf * MAT_ITEMSIZE[storage]
              + splits * 2 * c * b * 4)
    return Work(nbytes, 8 * live * c + (2 * live * c if q else 0))


def step_reduce_work(c: int, b: int, splits: int) -> Work:
    """``step_reduce``: partial sums [splits, 2, C, B] and dcfix -> acc [C, 2B]."""
    return Work(splits * 2 * c * b * 4 + 2 * c * 4 + c * 2 * b * 4, splits * 2 * c * b)


def sched_widths_work(p: int, entries: int, chunks: int) -> Work:
    """``sched_widths``: the [P, L] chunk tables -> the [P, chunks] widths."""
    return Work(2 * p * entries * 4 + p * chunks * 4, 0)


def chunked_work(storage: str, kb: int, s: int, m: int, c: int) -> Work:
    """One bucket's product of the chunked engine for one chunk of S blocks,
    ``tcat [Kb, 2S, 2M] @ hists [Kb, 2M, C] -> [Kb, 2S, C]``: the Toeplitz
    operand and the spectrum window read once (bf16 for ``"bf16"``, float32
    otherwise), the float32 product written once; 2 Kb 2S 2M C operations
    (at the headline, K = 513, S = 128, M = 938 + 127, C = 64: 35.8 G per
    chunk, 1.12 GB of ``tcat`` in float32)."""
    item = ITEMSIZE["bf16"] if storage == "bf16" else 4
    nbytes = kb * 2 * s * 2 * m * item + kb * 2 * m * c * item + kb * 2 * s * c * 4
    return Work(nbytes, 2 * kb * 2 * s * 2 * m * c)
