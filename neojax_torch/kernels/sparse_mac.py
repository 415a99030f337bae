"""The sparse schedules and the tile-sparse FDL MAC, B4 (``csrc/fdl_mac.cu``).

Replaces ``neojax/kernels/sparse_mac.py``: the host-side schedule builders
(``lane_widths``, ``build_chunk_schedule``, ``build_sparse_schedule``,
copied so that the tables equal neojax's bit for bit) and
``sparse_fdl_mac_pallas`` (Pallas body ``_mk_kernel``).

The reference's sparse filter keeps its bins in a CSR matrix and MACs only
those (``sparse_filter.hpp:16``, ``multiply_add.hpp:306-324``). Here, as in
neojax, the mask prunes at tile granularity: the ring rotates the filter by
one partition a block, so the active tiles of every rotation are tabulated
once at filter setup as ``[P, L]`` rows, padded with flag-0 entries.

- ``build_sparse_schedule`` -> B4 (the unfused MAC): row ``pos`` lists the
  active (k-tile, p-chunk) pairs, k-major.
- ``build_chunk_schedule`` -> B2/B3 (``kernels.fused_step``, ``sched=``):
  row ``pos`` lists the active partition chunks, each with a lane-width
  code in bits 16+ (only the first ``B >> code`` lanes are live).

On the card B4 is B1's kernel (the partition MAC of ``csrc/step_mac.cuh``)
reading, for its ring position, a row of :func:`tile_live_table`: uint8
``[P, P / pc, NK]``, 1 where row ``pos`` visits (p-chunk, k-tile). The
table is derived from the three ``[P, L]`` tables alone, once beside them
(``conv.convolver`` keeps it as ``params["tile_live"]``), so a call reads
one row of it instead of scanning the schedule row in every thread. A
thread skips the chunks its lanes never visit, in B1's summation order
and split geometry: on a masked filter B4 equals B1 bit for bit, apart
from the sign of zero.

:func:`sparse_fdl_mac_reference` is B4's plain PyTorch version (float64
products): the wrapper runs it for CPU tensors; on CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.kernels.fdl_mac import _check_args, _launch, fdl_mac_reference

__all__ = [
    "lane_widths",
    "build_chunk_schedule",
    "build_sparse_schedule",
    "tile_live_table",
    "sparse_fdl_mac",
    "sparse_fdl_mac_reference",
]


def lane_widths(b: int) -> list[int]:
    """Quantized live-lane widths for the fused kernels' lane skipping:
    [b, b/2, b/4, ...] down to the 128-lane tile floor. Width code ``w``
    means "only the first ``lane_widths(b)[w]`` lanes of this chunk are
    live"; cutoffs round UP to a width."""
    out = [b]
    while out[-1] % 2 == 0 and out[-1] // 2 >= 128 and out[-1] // 2 % 128 == 0:
        out.append(out[-1] // 2)
    return out


def build_chunk_schedule(mask: np.ndarray, p_chunk: int, lanes: int | None = None):
    """Chunk-level sparse schedule for the FUSED step.

    ``mask`` [P, K] or [P, C', K] ->
    ``{"c_idx": [P, L] i32, "flags": [P, L] i32, "density": float,
    "lane_density": float}`` where row ``w`` lists the chunk indices
    (ascending) containing at least one ring slot whose rotated filter
    partition is unmasked at write position ``w``. Padded with flag-0
    entries pointing at the last real chunk.

    ``lanes`` (the packed lane count B) adds a lane-width code in bits 16+
    (``c_idx = chunk | code << 16``): only the first ``lane_widths(B)[code]``
    lanes of the chunk are live (the perceptual mask keeps low bins in every
    partition, so it skips lanes rather than chunks). Exact: bins outside
    the mask are zero in the filter.
    """
    mask = np.asarray(mask, bool)
    if mask.ndim == 3:
        mask = mask.any(axis=1)
    active_part = mask.any(axis=1)  # [P]
    p = active_part.shape[0]
    if p % p_chunk:
        raise ValueError(f"P={p} not a multiple of p_chunk={p_chunk}")
    npc = p // p_chunk

    widths = lane_widths(lanes) if lanes else None
    if widths is not None:
        # Highest live PACKED lane per partition: cols 0..B-1 are lanes,
        # col B (Nyquist) lives in lane 0 of the im plane.
        k = mask.shape[1]
        lane_live = mask[:, : min(lanes, k)].copy()
        if k > lanes:
            lane_live[:, 0] |= mask[:, lanes]
        hi = np.where(
            lane_live.any(axis=1),
            lane_live.shape[1] - 1 - np.argmax(lane_live[:, ::-1], axis=1),
            -1,
        )
        need = hi + 1  # [P] lanes needed (0 = none)

    rev = active_part[::-1]
    tiled = np.concatenate([rev, rev], axis=0)
    if widths is not None:
        need_tiled = np.concatenate([need[::-1], need[::-1]], axis=0)
    rows = []
    codes = []
    for w in range(p):
        rot = tiled[p - 1 - w : 2 * p - 1 - w]  # rot[i] = active[(w - i) % P]
        act = rot.reshape(npc, p_chunk).any(axis=1)
        cc = np.nonzero(act)[0]
        rows.append(cc)
        if widths is not None:
            rot_need = need_tiled[p - 1 - w : 2 * p - 1 - w]
            chunk_need = rot_need.reshape(npc, p_chunk).max(axis=1)[cc]
            code = np.zeros(len(cc), np.int32)
            for ci, wd in enumerate(widths[1:], start=1):
                code[chunk_need <= wd] = ci
            codes.append(code)
    lengths = [len(r) for r in rows]
    l_max = max(lengths)
    if l_max == 0:
        raise ValueError("empty sparsity mask: no active partitions")
    c_idx = np.zeros((p, l_max), np.int32)
    flags = np.zeros((p, l_max), np.int32)
    lane_cost = []
    for w, cc in enumerate(rows):
        n = len(cc)
        ent = cc.astype(np.int32)
        if widths is not None and n:
            ent = ent | (codes[w] << 16)
            lane_cost.append(float(np.sum([widths[c] for c in codes[w]])) / (npc * (lanes or 1)))
        c_idx[w, :n] = ent
        flags[w, :n] = 1
        if n < l_max:
            c_idx[w, n:] = ent[-1] if n else 0
    return {
        "c_idx": c_idx,
        "flags": flags,
        "density": float(np.mean(lengths) / npc),
        "lane_density": float(np.mean(lane_cost)) if lane_cost else float(np.mean(lengths) / npc),
    }


def build_sparse_schedule(mask: np.ndarray, p_chunk: int, k_tile: int):
    """mask [P, K] or [P, C', K] (any-channel OR) -> schedule dict.

    Returns ``{"k_idx": [P, L] i32, "p_idx": [P, L] i32, "flags": [P, L] i32,
    "lane_mask": [K] bool, "density": float}`` where row ``w`` lists the
    active (k-tile, p-chunk) pairs of the filter rotated to write position
    ``w`` (ring slot i multiplies filter partition (w - i) mod P, the
    reference's ``fdl_index`` schedule, ``fdl_index.hpp:24-36``), k-major,
    padded to the longest row L with flag-0 entries. ``density`` is the
    mean fraction of tiles visited across rotations.
    """
    mask = np.asarray(mask, bool)
    if mask.ndim == 3:
        mask = mask.any(axis=1)
    p, k = mask.shape
    if p % p_chunk:
        raise ValueError(f"P={p} not a multiple of p_chunk={p_chunk}")
    nk = -(-k // k_tile)
    npc = p // p_chunk
    padk = np.zeros((p, nk * k_tile), bool)
    padk[:, :k] = mask
    q = padk.reshape(p, nk, k_tile).any(axis=2)  # [P, NK] per-partition tiles
    lane_mask = np.repeat(q.any(axis=0), k_tile)[:k]

    rev = q[::-1]
    tiled = np.concatenate([rev, rev], axis=0)  # [2P, NK]
    rows = []
    for w in range(p):
        rot = tiled[p - 1 - w : 2 * p - 1 - w]  # rot[i] = q[(w - i) % P]
        act = rot.reshape(npc, p_chunk, nk).any(axis=1)  # [NPC, NK]
        cc, kk = np.nonzero(act)
        order = np.lexsort((cc, kk))  # k-major
        rows.append((kk[order], cc[order]))
    lengths = [len(r[0]) for r in rows]
    l_max = max(lengths)
    if l_max == 0:
        raise ValueError("empty sparsity mask: no active tiles")
    k_idx = np.zeros((p, l_max), np.int32)
    p_idx = np.zeros((p, l_max), np.int32)
    flags = np.zeros((p, l_max), np.int32)
    for w, (kk, cc) in enumerate(rows):
        n = len(kk)
        k_idx[w, :n] = kk
        p_idx[w, :n] = cc
        flags[w, :n] = 1
        if n < l_max:  # pad pointing at the last real tile (skipped)
            k_idx[w, n:] = kk[-1] if n else 0
            p_idx[w, n:] = cc[-1] if n else 0
    return {
        "k_idx": k_idx,
        "p_idx": p_idx,
        "flags": flags,
        "lane_mask": lane_mask,
        "density": float(np.mean(lengths) / (nk * npc)),
    }


def tile_live_table(k_idx, p_idx, flags, npc: int, nk: int):
    """B4's tile-live table of :func:`build_sparse_schedule`'s ``[R, L]``
    int32 tables (R rows, any device): uint8 ``[R, npc, nk]``, 1 where the
    row holds a flag-1 entry (k_idx = t, p_idx = j) for p-chunk j and k-tile
    t, else 0. Derived from the tables alone (not from a mask), so converted
    params get the same table."""
    rows = k_idx.shape[0]
    if k_idx.device.type == "cpu" and rows and bool(
            (k_idx.min() < 0) | (k_idx.max() >= nk) | (p_idx.min() < 0) | (p_idx.max() >= npc)):
        raise ValueError(f"schedule entries outside {npc} p-chunks x {nk} k-tiles")
    base = torch.arange(rows, device=k_idx.device)[:, None] * (npc * nk)
    idx = (base + p_idx.long() * nk + k_idx.long()).reshape(-1)
    live = torch.zeros(rows * npc * nk, dtype=torch.int32, device=k_idx.device)
    live.scatter_reduce_(0, idx, (flags == 1).reshape(-1).to(torch.int32), "amax")
    return live.to(torch.uint8).view(rows, npc, nk)


def _check_tables(fdl, pos, tables, p_chunk, k_tile):
    p, k = fdl.shape[1], fdl.shape[3]
    shape = tuple(tables[0].shape)
    for name, t in zip(("k_idx", "p_idx", "flags"), tables):
        if t.dtype != torch.int32 or t.ndim != 2 or tuple(t.shape) != shape or t.shape[0] != p:
            raise ValueError(f"{name} must be int32 [{p}, L] like k_idx, got {t.dtype} {tuple(t.shape)}")
        if t.device != fdl.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on the ring's device")
    if not 0 <= pos < p:
        raise ValueError(f"pos {pos} outside [0, {p})")
    if p_chunk < 1 or p % p_chunk or k_tile < 1:
        raise ValueError(f"p_chunk={p_chunk} must divide P={p}, k_tile={k_tile} must be >= 1")
    return p, k, shape[1]


def sparse_fdl_mac_reference(fdl, filt_re, filt_im, pos, k_idx, p_idx, flags, scales=None, *,
                             p_chunk: int, k_tile: int):
    """Plain PyTorch B4: B1's float64 MAC over the filter with every
    (k-tile, p-chunk) pair that row ``pos`` does not visit zeroed, so lanes
    of unvisited tiles come out 0. Returns (acc_re, acc_im) [C, K] f32."""
    p, k = fdl.shape[1], fdl.shape[3]
    row = torch.stack([k_idx[pos], p_idx[pos], flags[pos]]).cpu()
    visit = torch.zeros((p, k), dtype=torch.bool)
    for kk, cc, fl in row.T.tolist():
        if fl == 1:
            visit[cc * p_chunk : (cc + 1) * p_chunk, kk * k_tile : (kk + 1) * k_tile] = True
    visit = visit.to(fdl.device)[:, None, :]
    zero = torch.zeros((), dtype=filt_re.dtype, device=fdl.device)
    return fdl_mac_reference(fdl, torch.where(visit, filt_re, zero), torch.where(visit, filt_im, zero),
                             scales)


def sparse_fdl_mac(fdl, filt_re, filt_im, pos, k_idx, p_idx, flags, scales=None, *,
                   p_chunk: int, k_tile: int, live=None):
    """Tile-sparse :func:`~neojax_torch.kernels.fdl_mac.fdl_mac`: only the
    (k-tile, p-chunk) pairs of row ``pos`` of the schedule are read and
    MAC'd, each chunk's rows in ascending order.

    fdl          : [2, P, C, K] f32 / bf16 / int16 / int8 (ring layout)
    filt_re/_im  : [P, C', K] f32, C' in {1, C}, ALREADY ring-rotated, with
                   masked bins zero
    pos          : int ring write position (selects the schedule row)
    k_idx, p_idx, flags : [P, L] int32 tables of :func:`build_sparse_schedule`
    scales       : [P, C] f32 for int storage
    p_chunk, k_tile : the geometry the tables were built with
    live         : their :func:`tile_live_table` [P, P / p_chunk, NK] uint8
                   on the ring's device, or None: the card then derives row
                   ``pos`` of it for this call

    Returns (acc_re, acc_im) [C, K] f32. Lanes in k-tiles that row ``pos``
    never visits are 0; the convolver still masks with ``lane_mask``, as
    neojax does (its TPU kernel leaves them undefined).
    """
    _check_args(fdl, filt_re, filt_im, scales)
    pos = int(pos)
    p, k, _ = _check_tables(fdl, pos, (k_idx, p_idx, flags), p_chunk, k_tile)
    npc, nk = p // p_chunk, -(-k // k_tile)
    if live is not None and (live.dtype != torch.uint8 or tuple(live.shape) != (p, npc, nk)
                             or live.device != fdl.device or not live.is_contiguous()):
        raise ValueError(f"live must be a contiguous uint8 [{p}, {npc}, {nk}] tensor on the ring's device")
    if fdl.device.type == "cpu":
        return sparse_fdl_mac_reference(fdl, filt_re, filt_im, pos, k_idx, p_idx, flags, scales,
                                        p_chunk=p_chunk, k_tile=k_tile)
    if fdl.device.type != "cuda":
        raise ValueError(f"sparse_fdl_mac: unsupported device {fdl.device}")
    row = (tile_live_table(k_idx[pos : pos + 1], p_idx[pos : pos + 1], flags[pos : pos + 1], npc, nk)
           if live is None else live[pos])
    acc = _launch("sparse_fdl_mac", fdl, filt_re, filt_im, scales, (row.data_ptr(), p_chunk, k_tile, nk))
    sparse_fdl_mac.launches += 1
    return acc[0], acc[1]


sparse_fdl_mac.launches = 0
